"""The port's tensor-parallel rules and shards (``tpuhar_torch/parallel/mesh.py``) against
the JAX package's (``tpuhar/parallel/mesh.py``), on the CPU, without a process group.

``tests/test_sharding.py``'s ``_cfg()`` widths: the IMU encoder at d=64 with 4 heads and 2
layers, ``videomae_tiny`` (4 blocks, d=192, 3 heads: its attention does not divide by 2
or 4, so it falls back to replication while its MLP splits) on 4 frames of 32², fusion
heads 4, f32; the parameters drawn by ``bridge.init_params``.

- ``partition_specs``: the port's spec of every parameter, named by its flax path
  through ``bridge``, equals JAX's spec of that leaf, for ``IMUClassifier``,
  ``FusionClassifier`` and ``CrossModalModel`` at model axes 1, 2 and 4;
- ``shard_params``: the port's model split at model rank ``r`` of a ``(8 // tp, tp)``
  mesh, read back in flax layout (``bridge.variables_to_numpy``), equals leaf for leaf
  and bit for bit the shard JAX's ``shard_params`` puts on the device at mesh position
  ``(0, r)`` of the conftest's 8 fake devices; each split attention computes ``H / tp``
  heads and each split block learns its ``ModelShard``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import init_params, load_variables, variables_to_numpy
from tpuhar_torch.config import Config
from tpuhar_torch.models.crossmodal import CrossModalModel, FusionClassifier, IMUClassifier
from tpuhar_torch.models.layers import MultiHeadDotProductAttention, PreNormBlock, TransformerEncoderBlock
from tpuhar_torch.ops.attention import FlashSelfAttention
from tpuhar_torch.parallel import mesh as M

MODELS = {"imu": IMUClassifier, "fusion": FusionClassifier, "crossmodal": CrossModalModel}


def config() -> Config:
    cfg = Config()
    m = cfg.model
    m.num_classes, m.imu_num_layers, m.imu_d_model, m.imu_nhead = 4, 2, 64, 4
    m.compute_dtype, m.head_norm = "float32", "layer"
    m.video_backbone, m.video_d_model, m.fusion_heads = "videomae_tiny", 64, 4
    m.use_flash_attention, m.flash_kernel = True, "library"
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 4
    return cfg


class StandInMesh:
    """What the port's mesh functions read of rank ``(0, model_rank)`` of a ``shape``
    mesh: the dims, their sizes, this rank's index on each (no process group)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, model_rank: int = 0):
        self.shape, self.model_rank = tuple(shape), model_rank

    def get_local_rank(self, axis):
        return self.model_rank if axis == "model" else 0

    def __getitem__(self, axis):
        size = dict(zip(self.mesh_dim_names, self.shape))[axis]
        return SimpleNamespace(size=lambda: size)

    def get_group(self, axis):
        return None


def _jax_mesh(tp: int):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:8]).reshape(8 // tp, tp), ("data", "model"))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.fixture(scope="module")
def variables():
    return {name: init_params(config(), torch.Generator().manual_seed(0), cls) for name, cls in MODELS.items()}


def _whole(name, variables):
    return load_variables(MODELS[name](config(), dtype=torch.float32), variables[name])


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_partition_specs_match_jax(variables, name, tp):
    from tpuhar.parallel.mesh import partition_specs

    theirs = dict(_flat(partition_specs(variables[name]["params"], _jax_mesh(tp))))
    mine = M.partition_specs(_whole(name, variables), StandInMesh((8 // tp, tp)))
    assert mine.keys() == theirs.keys()
    for path, spec in theirs.items():
        assert tuple(mine[path]) == tuple(spec), path
    split = [p for p, s in mine.items() if any(a is not None for a in s)]
    if tp == 1:
        assert not split
    else:  # the fallback: videomae_tiny's 3 heads stay whole, its MLP splits
        assert not any("vit" in p and "attn" in p for p in split)
        assert (name == "imu") or any("vit" in p and "mlp_in" in p for p in split)
        assert any("linear1" in p for p in split) and any("self_attn/query" in p for p in split)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_shard_params_are_jax_device_shards(variables, name, tp):
    import jax

    from tpuhar.parallel.mesh import shard_params

    jmesh = _jax_mesh(tp)
    placed = dict(_flat(shard_params(variables[name]["params"], jmesh)))
    for rank in range(tp):
        model = M.shard_params(_whole(name, variables), StandInMesh((8 // tp, tp), rank))
        assert model.model_shard == M.ModelShard(rank, tp, None)
        mine = dict(_flat(variables_to_numpy(model)["params"]))
        device = jmesh.devices[0, rank]
        n_split = 0
        for path, array in placed.items():
            (shard,) = [s for s in array.addressable_shards if s.device == device]
            want = np.asarray(jax.device_get(shard.data))
            np.testing.assert_array_equal(mine[path], want, err_msg=path)
            n_split += want.shape != array.shape
        assert n_split == len(model.tp_dims) > 0
        for mod in model.modules():
            if isinstance(mod, (MultiHeadDotProductAttention, FlashSelfAttention)):
                vit = mod.query.in_features == 192  # 3 heads: whole
                assert mod.tp == (None if vit else model.model_shard)
                assert mod.num_heads * mod.head_dim == mod.query.out_features == mod.out.in_features
                assert mod.query.out_features * (1 if vit else tp) == mod.out.out_features
            if isinstance(mod, (TransformerEncoderBlock, PreNormBlock)):
                assert mod.mlp_tp == model.model_shard
