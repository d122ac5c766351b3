"""The port's data-parallel serving engine (``InferenceEngine(mesh=...)``) on the CPU:
two spawned ranks (gloo) against the engine without a mesh and against the JAX
package's mesh engine (``tests/test_serving.py:138``, ``:210``).

The fusion classifier on the ``tiny_cnn`` tower at 32², 4 frames, IMU d=32, registered
sizes 4 and 8 (2 and 4 rows a rank), f32. Each rank answers every request; what it
returns is the global answer:

- bit for bit what the engine without a mesh gives for each rank's rows on their own
  (the same program on the same rows);
- against the engine without a mesh on the whole request, and against the JAX
  package's engine on a ``(2, 1)`` mesh: ``preds`` equal, logits, MSP, energy and
  embeddings within 1e-4 (``tests/test_serving.py:151``'s bound; the rows' batch differs,
  so the sums may round differently);
- padded (5 → 8, 3 → 4) and chunked (11 → 8 + 3) requests, ``predict_stream`` over
  batches of 8, 3, 8 and 5, and ``fit_embedding_scorers``, which carries the mesh;
- a registered size that does not divide over the ranks raises at construction.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import init_params
from tpuhar_torch.config import Config
from tpuhar_torch.serving import InferenceEngine

from test_torch_mesh import free_port

torch.set_num_threads(2)

ATOL = 1e-4
SIZES = [4, 8]
REQUESTS = (8, 5, 3, 11)
STREAM = (8, 3, 8, 5)
VALUES = ("logits", "msp", "energy", "embeddings")


def config() -> Config:
    cfg = Config()
    m = cfg.model
    m.compute_dtype, m.num_classes, m.head_norm = "float32", 4, "layer"
    m.video_backbone, m.video_d_model = "tiny_cnn", 64
    m.imu_d_model, m.imu_nhead, m.imu_num_layers, m.fusion_heads = 32, 4, 1, 4
    m.classifier_hidden_dims = [16]
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 4
    return cfg


def variables():
    return init_params(config(), torch.Generator().manual_seed(0))


def inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 8000, (n, 250, 6)).astype(np.float32),
            rng.integers(0, 256, (n, 4, 32, 32, 3), dtype=np.uint8))


def serve(engine) -> dict:
    out = {"predict": [engine.predict(*inputs(n, n)) for n in REQUESTS],
           "stream": list(engine.predict_stream([inputs(n, 100 + i) for i, n in enumerate(STREAM)]))}
    imu, video = inputs(8, 50)
    refit = engine.fit_embedding_scorers(imu, video, np.arange(8) % 4, scores=("mahalanobis", "knn"))
    out["refit_mesh"] = refit.mesh is engine.mesh
    out["refit"] = refit.predict(*inputs(5, 51))
    return out


def _rank(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from tpuhar_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
    try:
        mesh = create_mesh()
        out = serve(InferenceEngine(config(), variables(), batch_sizes=SIZES, mesh=mesh, device="cpu"))
        try:
            InferenceEngine(config(), variables(), batch_sizes=[3, 8], mesh=mesh, device="cpu")
        except ValueError as e:
            out["uneven"] = str(e)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("engine_mesh")
    torch.multiprocessing.start_processes(_rank, args=(free_port(), str(out)), nprocs=2, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def plain():
    return InferenceEngine(config(), variables(), batch_sizes=SIZES, device="cpu")


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _close(got, want):
    np.testing.assert_array_equal(got["preds"], want["preds"])
    for k in VALUES:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)


def _by_halves(engine, imu, video) -> dict:
    """The program of the engine without a mesh on each rank's rows of the padded
    request, joined."""
    n = imu.shape[0]
    if n > SIZES[-1]:
        parts = [_by_halves(engine, imu[i:i + SIZES[-1]], video[i:i + SIZES[-1]]) for i in range(0, n, SIZES[-1])]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    b = engine._padded_size(n)
    padded = engine._pad_to(imu, video, b)
    parts = [engine._forward(*(torch.from_numpy(a[i:i + b // 2]) for a in padded)) for i in (0, b // 2)]
    return {k: np.concatenate([p[k].numpy() for p in parts])[:n] for k in parts[0]}


def test_ranks_return_the_global_answer(world2):
    a, b = world2
    for x, y in zip(a["predict"] + a["stream"], b["predict"] + b["stream"]):
        _equal(x, y)
    assert [len(o["preds"]) for o in a["predict"]] == list(REQUESTS)
    assert [len(o["preds"]) for o in a["stream"]] == list(STREAM)
    assert a["refit_mesh"] and b["refit_mesh"]
    assert "do not divide" in a["uneven"] and "[3]" in a["uneven"]


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_predict_is_each_rank_rows_bit_for_bit(world2, plain, i):
    n = REQUESTS[i]
    got = world2[0]["predict"][i]
    _equal(got, _by_halves(plain, *inputs(n, n)))
    _close(got, plain.predict(*inputs(n, n)))


def test_predict_stream_matches_the_plain_engine(world2, plain):
    for i, (got, n) in enumerate(zip(world2[0]["stream"], STREAM)):
        _equal(got, _by_halves(plain, *inputs(n, 100 + i)))
        _close(got, plain.predict(*inputs(n, 100 + i)))


def test_refit_engine_keeps_the_mesh(world2, plain):
    imu, video = inputs(8, 50)
    refit = plain.fit_embedding_scorers(imu, video, np.arange(8) % 4, scores=("mahalanobis", "knn"))
    got, want = world2[0]["refit"], refit.predict(*inputs(5, 51))
    _close(got, want)
    for k in ("mahalanobis", "knn"):
        np.testing.assert_allclose(got[k], want[k], rtol=ATOL, err_msg=k)


def test_matches_the_jax_mesh_engine(world2):
    import jax
    from jax.sharding import Mesh

    from tpuhar.config import Config as JConfig
    from tpuhar.serving import InferenceEngine as JaxEngine

    jcfg = JConfig()
    for section in ("model", "data", "ood"):
        for key, value in vars(getattr(config(), section)).items():
            setattr(getattr(jcfg, section), key, value)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    engine = JaxEngine(jcfg, variables(), batch_sizes=[8], mesh=mesh)
    _close(world2[0]["predict"][0], engine.predict(*inputs(8, 8)))
    stream = [inputs(n, 100 + i) for i, n in enumerate(STREAM)]
    for got, want in zip(world2[0]["stream"], engine.predict_stream(stream)):
        _close(got, want)
