"""Weights I/O of the port (``tpuhar_torch/models/convert.py``) against the JAX
package's (``tpuhar/models/convert.py``), on the CPU.

The inputs are built here: a tiny HF ``VideoMAEModel`` from a ``VideoMAEConfig`` with
random weights (nothing is downloaded) and torchvision's ResNet-18 and MobileNetV2
state-dict schemas with seeded random values. Every converted and exported tree is held
to the JAX package's bit for bit (both are numpy layout rewrites of the same values);
the port's ViT on the converted weights is held to HF's own forward in f32 within
``atol=2e-4, rtol=2e-3`` (the JAX package's own bound for its ViT against HF); a task
built with ``model.video_weights_path`` holds the tree the JAX package's task grafts,
bit for bit, read back through ``bridge.variables_to_numpy``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuhar_torch.bridge import variables_to_numpy
from tpuhar_torch.config import Config
from tpuhar_torch.models import convert as pc
from tpuhar_torch.models.video import VideoViT
from tpuhar_torch.train import factory as pfactory

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def assert_tree_equal(a, b):
    """Same keys, and every leaf the same array bit for bit."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def assert_sd_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _hf_videomae(depth=2, d_model=192, heads=3, frames=4, **kw):
    from transformers import VideoMAEConfig, VideoMAEModel

    torch.manual_seed(0)
    return VideoMAEModel(VideoMAEConfig(
        hidden_size=d_model, num_hidden_layers=depth, num_attention_heads=heads,
        intermediate_size=d_model * 4, image_size=32, num_frames=frames, tubelet_size=2,
        patch_size=16, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **kw,
    )).eval()


def _fake_resnet18_state_dict(rng):
    """torchvision's ``resnet18`` state-dict schema with random values."""
    sd = {}

    def conv(k, cout, cin, ksize):
        sd[k] = torch.from_numpy(rng.normal(0, 0.05, size=(cout, cin, ksize, ksize)).astype(np.float32))

    def bn(prefix, c):
        sd[prefix + ".weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[prefix + ".bias"] = torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32))
        sd[prefix + ".running_mean"] = torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32))
        sd[prefix + ".running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    chans = [64, 64, 128, 256, 512]
    for li in range(4):
        cin, cout = chans[li], chans[li + 1]
        for bi in range(2):
            conv(f"layer{li + 1}.{bi}.conv1.weight", cout, cin if bi == 0 else cout, 3)
            bn(f"layer{li + 1}.{bi}.bn1", cout)
            conv(f"layer{li + 1}.{bi}.conv2.weight", cout, cout, 3)
            bn(f"layer{li + 1}.{bi}.bn2", cout)
            if bi == 0 and li > 0:
                conv(f"layer{li + 1}.0.downsample.0.weight", cout, cin, 1)
                bn(f"layer{li + 1}.0.downsample.1", cout)
    sd["fc.weight"] = torch.zeros(1000, 512)  # the head, which conversion drops
    return sd


def _fake_mobilenet_v2_state_dict(rng):
    """torchvision's ``mobilenet_v2`` state-dict schema with random values."""
    sd = {}

    def conv(k, cout, cin, ksize):
        sd[k] = torch.from_numpy(rng.normal(0, 0.05, size=(cout, cin, ksize, ksize)).astype(np.float32))

    def bn(prefix, c):
        sd[prefix + ".weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[prefix + ".bias"] = torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32))
        sd[prefix + ".running_mean"] = torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32))
        sd[prefix + ".running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))

    outs = [16, 24, 24, 32, 32, 32, 64, 64, 64, 64, 96, 96, 96, 160, 160, 160, 320]
    conv("features.0.0.weight", 32, 3, 3)
    bn("features.0.1", 32)
    cin = 32
    for i, cout in enumerate(outs):
        tp, expand = f"features.{i + 1}.conv", 1 if i == 0 else 6
        hidden = cin * expand
        if expand == 1:
            conv(f"{tp}.0.0.weight", hidden, 1, 3)
            bn(f"{tp}.0.1", hidden)
            conv(f"{tp}.1.weight", cout, hidden, 1)
            bn(f"{tp}.2", cout)
        else:
            conv(f"{tp}.0.0.weight", hidden, cin, 1)
            bn(f"{tp}.0.1", hidden)
            conv(f"{tp}.1.0.weight", hidden, 1, 3)
            bn(f"{tp}.1.1", hidden)
            conv(f"{tp}.2.weight", cout, hidden, 1)
            bn(f"{tp}.3", cout)
        cin = cout
    conv("features.18.0.weight", 1280, 320, 1)
    bn("features.18.1", 1280)
    sd["classifier.1.weight"] = torch.zeros(1000, 1280)
    return sd


def _randomize(tree, rng):
    """Random positive values in every leaf of a tree of shapes (positive keeps a
    BatchNorm variance valid)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(
        treedef, [np.asarray(rng.uniform(0.1, 1.0, size=x.shape), np.float32) for x in leaves]
    )


# ---------------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["bare", "classification"])
def test_videomae_conversion_matches_jax(layout):
    from tpuhar.models.convert import convert_videomae_state_dict

    hf = _hf_videomae()
    sd = hf.state_dict()
    if layout == "classification":  # VideoMAEForVideoClassification: prefixed, plus a head
        sd = {"videomae." + k: v for k, v in sd.items()}
        sd["classifier.weight"], sd["classifier.bias"] = torch.zeros(7, 192), torch.zeros(7)
    mine = pc.convert_videomae_state_dict(sd, 2, 192, 3, 8)
    assert_tree_equal(mine, convert_videomae_state_dict(sd, 2, 192, 3, 8))
    assert "final_norm" not in mine  # HF's default mean pooling keeps no final LayerNorm
    np.testing.assert_array_equal(mine["block0"]["self_attn"]["key"]["bias"], 0)


@pytest.mark.parametrize("missing", ["layernorm.bias", "layernorm.weight"])
def test_videomae_partial_final_norm_matches_jax(missing):
    """A final LayerNorm with one of its two keys is left out of the converted tree,
    as the JAX converter leaves it out (its weight alone once raised in the port)."""
    from tpuhar.models.convert import convert_videomae_state_dict

    sd = _hf_videomae().state_dict()
    sd["layernorm.weight"], sd["layernorm.bias"] = torch.ones(192), torch.zeros(192)
    del sd[missing]
    mine = pc.convert_videomae_state_dict(sd, 2, 192, 3, 8)
    assert_tree_equal(mine, convert_videomae_state_dict(sd, 2, 192, 3, 8))
    assert "final_norm" not in mine


@pytest.mark.parametrize("backbone", ["resnet18", "mobilenet_v2"])
def test_cnn_conversion_matches_jax(backbone):
    from tpuhar.models import convert as jc

    rng = np.random.default_rng(1)
    sd = _fake_resnet18_state_dict(rng) if backbone == "resnet18" else _fake_mobilenet_v2_state_dict(rng)
    fn = f"convert_{backbone}_state_dict"
    p, s = getattr(pc, fn)(sd)
    jp, js = getattr(jc, fn)(sd)
    assert_tree_equal(p, jp)
    assert_tree_equal(s, js)


def test_sinusoid_table_matches_jax_and_hf():
    from transformers.models.videomae.modeling_videomae import get_sinusoid_encoding_table

    from tpuhar.models.convert import sinusoid_position_table

    ours = pc.sinusoid_position_table(16, 64)
    np.testing.assert_array_equal(ours, sinusoid_position_table(16, 64))
    np.testing.assert_allclose(ours, get_sinusoid_encoding_table(16, 64).numpy(), atol=1e-6)


def test_converted_vit_matches_hf_forward():
    """The port's ``VideoViT`` on the converted weights gives HF's hidden states in f32
    (atol 2e-4, rtol 2e-3: the JAX package's bound for its own ViT against HF)."""
    from tpuhar_torch.bridge import load_variables

    hf = _hf_videomae()
    B, T, H, W = 2, 4, 32, 32
    x = np.random.default_rng(0).normal(size=(B, T, 3, H, W)).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(x)).last_hidden_state.numpy()
    params = pc.convert_videomae_state_dict(hf.state_dict(), 2, 192, 3, 8)
    vit = load_variables(VideoViT(8, 2, 192, 3, use_final_norm=False), {"params": params}).eval()
    with torch.no_grad():
        _, tokens = vit(torch.from_numpy(x.transpose(0, 1, 3, 4, 2)))
    np.testing.assert_allclose(tokens.numpy(), want, atol=2e-4, rtol=2e-3)


# ---------------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------------
def _jax_vit_params(rng, depth=4, d_model=192, heads=3):
    from tpuhar.models.video import VideoViT as JViT

    net = JViT(depth=depth, d_model=d_model, num_heads=heads)
    return _randomize(jax.eval_shape(net.init, KEY, jnp.zeros((1, 4, 32, 32, 3)))["params"], rng)


def test_videomae_export_matches_jax_and_round_trips(tmp_path):
    """Every leaf random (a drifted position table, a nonzero key bias): the port's
    export equals the JAX package's key for key, ``convert(export(p)) == p`` bit for bit,
    also through ``.pt`` and ``.npz`` files."""
    from tpuhar.models.convert import export_videomae_state_dict

    params = _jax_vit_params(np.random.default_rng(2))
    sd = pc.export_videomae_state_dict(params, 4, 3)
    assert_sd_equal(sd, export_videomae_state_dict(params, 4, 3))
    assert "encoder.layer.0.attention.attention.k_bias" in sd and "embeddings.position_embeddings" in sd
    n = params["pos_encoding"].shape[1]
    assert_tree_equal(pc.convert_videomae_state_dict(sd, 4, 192, 3, n), params)
    for name in ("vit.pt", "vit.npz"):
        pc.save_state_dict(sd, tmp_path / name)
        assert_tree_equal(pc.convert_videomae_state_dict(pc.load_state_dict(tmp_path / name), 4, 192, 3, n), params)


def test_zero_key_bias_exports_the_hf_key_set():
    from tpuhar.models.video import VideoViT as JViT

    params = JViT(depth=2, d_model=48, num_heads=2).init(KEY, jnp.zeros((1, 4, 32, 32, 3)))["params"]
    sd = pc.export_videomae_state_dict(params, 2, 2)
    assert not any(k.endswith(".k_bias") for k in sd)


@pytest.mark.parametrize("backbone", ["resnet18", "mobilenet_v2"])
def test_cnn_export_matches_jax_and_round_trips(backbone, tmp_path):
    from tpuhar.models import convert as jc
    from tpuhar.models.video import MobileNetV2, ResNet18

    rng = np.random.default_rng(3)
    net = ResNet18() if backbone == "resnet18" else MobileNetV2()
    variables = jax.eval_shape(net.init, KEY, jnp.zeros((1, 32, 32, 3)))
    params, stats = _randomize(variables["params"], rng), _randomize(variables["batch_stats"], rng)
    sd = getattr(pc, f"export_{backbone}_state_dict")(params, stats)
    assert_sd_equal(sd, getattr(jc, f"export_{backbone}_state_dict")(params, stats))
    pc.save_state_dict(sd, tmp_path / "cnn.pth")
    p2, s2 = getattr(pc, f"convert_{backbone}_state_dict")(pc.load_state_dict(tmp_path / "cnn.pth"))
    assert_tree_equal(p2, params)
    assert_tree_equal(s2, stats)


def test_export_video_backbone_dispatch():
    cfg = _graft_cfg("resnet18")
    rng = np.random.default_rng(4)
    p, s = pc.convert_resnet18_state_dict(_fake_resnet18_state_dict(rng))
    variables = {"params": {"backbone": p, "projection": {}}, "batch_stats": {"backbone": s}}
    sd = pc.export_video_backbone(variables, cfg)
    regrafted = pc.graft_video_backbone(variables, pc.convert_video_backbone(sd, cfg), "resnet18")
    assert_tree_equal(regrafted["params"]["backbone"], p)
    assert_tree_equal(regrafted["batch_stats"]["backbone"], s)
    cfg.model.video_backbone = "tpu_cnn"
    with pytest.raises(ValueError, match="no torch-layout export"):
        pc.export_video_backbone({"params": {}}, cfg)
    with pytest.raises(ValueError, match="no torch-weight converter"):
        pc.convert_video_backbone({}, cfg)


# ---------------------------------------------------------------------------------
# prefixes, errors, the final-norm gate
# ---------------------------------------------------------------------------------
def test_training_wrapper_prefixes_are_stripped(tmp_path):
    from tpuhar.models.convert import normalize_state_dict

    sd = _fake_resnet18_state_dict(np.random.default_rng(5))
    for wrapped in ({"model.module." + k: v for k, v in sd.items()}, {"state_dict": {"module." + k: v for k, v in sd.items()}}):
        torch.save(wrapped, tmp_path / "w.pt")
        assert set(pc.load_state_dict(tmp_path / "w.pt")) == set(sd)
    partial = {"videomae.x": 1, "classifier.weight": 2}
    assert pc.normalize_state_dict(partial) == normalize_state_dict(partial) == partial


def test_missing_key_names_the_nearest():
    from tpuhar.models.convert import convert_resnet18_state_dict

    sd = _fake_resnet18_state_dict(np.random.default_rng(6))
    del sd["layer2.0.conv1.weight"]
    with pytest.raises(KeyError, match="nearest present") as mine:
        pc.convert_resnet18_state_dict(sd)
    with pytest.raises(KeyError) as theirs:
        convert_resnet18_state_dict(sd)
    near = str(theirs.value).split("nearest present: ")[1].split(")")[0]
    assert near in str(mine.value)
    vsd = pc.export_videomae_state_dict(_jax_vit_params(np.random.default_rng(7), 2, 24, 3), 2, 3)
    del vsd["encoder.layer.1.intermediate.dense.weight"]
    with pytest.raises(KeyError, match="nearest present"):
        pc.convert_videomae_state_dict(vsd, 2, 24, 3, 8)


def _graft_cfg(backbone="resnet18"):
    cfg = Config()
    m = cfg.model
    m.video_backbone, m.compute_dtype, m.head_norm = backbone, "float32", "layer"
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 1
    m.video_d_model, m.projection_dim, m.projection_hidden_dim = 64, 16, 32
    m.num_classes, m.fusion_heads, m.classifier_hidden_dims = 4, 4, [16]
    cfg.data.video_resize = (32, 32)
    cfg.data.video_frames_per_window = 2 if backbone == "resnet18" else 4
    cfg.training.pretrain_batch_size = 2
    return cfg


def _jax_cfg(cfg):
    from tpuhar.config import Config as JConfig

    jcfg = JConfig()
    for section in ("model", "training", "data"):
        for key, value in vars(getattr(cfg, section)).items():
            setattr(getattr(jcfg, section), key, value)
    return jcfg


def test_final_norm_gate():
    """A mean-pooling checkpoint (no final LayerNorm) converts only for a model built
    with ``video_use_final_norm=False``, as in the JAX package."""
    from tpuhar.models.convert import convert_video_backbone

    hf = _hf_videomae(depth=4)  # videomae_tiny's shape
    sd = hf.state_dict()
    cfg = _graft_cfg("videomae_tiny")
    with pytest.raises(ValueError, match="video_use_final_norm"):
        pc.convert_video_backbone(sd, cfg)
    cfg.model.video_use_final_norm = False
    assert_tree_equal(pc.convert_video_backbone(sd, cfg), convert_video_backbone(sd, _jax_cfg(cfg)))


def _jax_task_variables(kind, jcfg):
    from tpuhar.train import factory as jfactory

    task = getattr(jfactory, f"build_{kind}_task")(jcfg, 1, KEY)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    return {"params": to_np(task.state.params), "batch_stats": to_np(task.state.batch_stats)}


@pytest.mark.parametrize("kind,backbone", [("crossmodal", "resnet18"), ("fusion", "videomae_tiny")])
def test_task_grafts_video_weights_as_jax(kind, backbone, tmp_path, capsys):
    """``build_{kind}_task`` with ``model.video_weights_path``: the port's model holds
    the JAX task's grafted tree bit for bit (both tasks start from the JAX package's
    fresh tree); with ``video_pretrained=False`` both print the skip and graft nothing."""
    cfg = _graft_cfg(backbone)
    rng = np.random.default_rng(8)
    if backbone == "resnet18":
        sd = _fake_resnet18_state_dict(rng)
    else:
        cfg.model.video_use_final_norm = False
        sd = _hf_videomae(depth=4).state_dict()
    path = tmp_path / "backbone.pt"
    torch.save(sd, path)
    base = _jax_task_variables(kind, _jax_cfg(cfg))  # the fresh tree, no path set
    cfg.model.video_weights_path = str(path)
    want = _jax_task_variables(kind, _jax_cfg(cfg))
    build = getattr(pfactory, f"build_{kind}_task")
    got = variables_to_numpy(build(cfg, 1, base, device="cpu").model)
    assert_tree_equal(got["params"], want["params"])
    assert_tree_equal(got["batch_stats"], want["batch_stats"])
    assert "grafted pretrained video weights" in capsys.readouterr().out

    cfg.model.video_pretrained = False
    got = variables_to_numpy(build(cfg, 1, base, device="cpu").model)
    assert "skipping graft" in capsys.readouterr().out
    assert_tree_equal(got["params"], base["params"])


def test_graft_refuses_a_checkpoint_of_another_shape(tmp_path):
    """A checkpoint whose MLP is narrower than the configured ViT's raises, naming the
    leaf, instead of grafting."""
    cfg = _graft_cfg("videomae_tiny")
    params = _jax_vit_params(np.random.default_rng(9))
    sd = pc.export_videomae_state_dict(params, 4, 3)
    sd["encoder.layer.0.intermediate.dense.weight"] = np.zeros((384, 192), np.float32)
    sd["encoder.layer.0.intermediate.dense.bias"] = np.zeros((384,), np.float32)
    pc.save_state_dict(sd, tmp_path / "other.npz")
    with pytest.raises(ValueError, match="does not fit.*mlp_in"):
        pc.graft_model_video_weights({"video_encoder": {"vit": params}}, {}, cfg, path=str(tmp_path / "other.npz"))
