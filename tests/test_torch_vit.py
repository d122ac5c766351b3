"""The port's ViT tower (``tpuhar_torch/models/{layers,video}.py``, ``ops/fold.py``,
``bridge.init_params``) against the JAX package's, f32 on the CPU, on the same flax
parameters and numpy inputs. JAX's flash attention takes its XLA path on the CPU; the
port's takes the kernel's plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.models.layers import PreNormBlock as JaxPreNormBlock
from tpuhar.models.video import VideoEncoder as JaxVideoEncoder
from tpuhar.models.video import VideoViT as JaxVideoViT
from tpuhar.ops.fold import fold_normalization as jax_fold_normalization
from tpuhar_torch.bridge import _flatten, init_params, load_variables
from tpuhar_torch.entry import vit_config
from tpuhar_torch.models.layers import PreNormBlock
from tpuhar_torch.models.video import VIT_CONFIGS, VideoEncoder, VideoViT
from tpuhar_torch.ops.fold import fold_normalization

torch.set_num_threads(2)

ATOL = 1e-4


def _perturbed(variables, seed):
    """Move every leaf off its init (zero biases, unit LayerNorm scales) by a seeded draw."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(variables),
    )


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("gelu_approximate", [True, False])
def test_pre_norm_block_matches_jax(use_flash, gelu_approximate):
    D, H = 128, 2
    x = np.random.default_rng(0).normal(0, 1, (2, 20, D)).astype(np.float32)
    net = JaxPreNormBlock(d_model=D, num_heads=H, d_ff=4 * D, use_flash=use_flash, gelu_approximate=gelu_approximate)
    variables = _perturbed(net.init(jax.random.PRNGKey(0), x), 1)
    want = np.asarray(net.apply(variables, x))
    block = load_variables(
        PreNormBlock(D, H, 4 * D, use_flash=use_flash, gelu_approximate=gelu_approximate), variables
    )
    with torch.inference_mode():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _clip(size, seed):
    return np.random.default_rng(seed).normal(0, 1, (2, 4, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size,tokens", [(32, 8), (48, 18), (64, 32)])
def test_video_vit_matches_jax(size, tokens):
    """``videomae_tiny`` (4 blocks, d=192, 3 heads) with the serving options and mean
    pooling."""
    depth, d, heads = VIT_CONFIGS["videomae_tiny"]
    clip = _clip(size, 2)
    net = JaxVideoViT(depth=depth, d_model=d, num_heads=heads, use_flash=True, gelu_approximate=True)
    variables = _perturbed(net.init(jax.random.PRNGKey(3), clip), 4)
    want_emb, want_tokens = (np.asarray(a) for a in net.apply(variables, clip))
    model = load_variables(
        VideoViT(tokens, depth, d, heads, use_flash=True, gelu_approximate=True), variables
    )
    with torch.inference_mode():
        emb, got_tokens = model(torch.from_numpy(clip))
    assert emb.dtype == torch.float32 and got_tokens.shape == (2, tokens, d)
    np.testing.assert_allclose(got_tokens.numpy(), want_tokens, atol=ATOL, rtol=0)
    np.testing.assert_allclose(emb.numpy(), want_emb, atol=ATOL, rtol=0)


def _encoder(size, use_flash, seed):
    clip = _clip(size, seed)
    net = JaxVideoEncoder(backbone="videomae_tiny", video_d_model=64, use_flash=use_flash)
    return net, _perturbed(net.init(jax.random.PRNGKey(seed), clip), seed + 1), clip


@pytest.mark.parametrize("size,tokens,use_flash", [(32, 8, True), (64, 32, False)])
def test_vit_video_encoder_matches_jax(size, tokens, use_flash):
    """The ViT branch: the ``vit`` submodule, then one ``projection`` for the pooled
    embedding and the tokens; exact-erf GELU, with and without flash."""
    net, variables, clip = _encoder(size, use_flash, 5)
    want_emb, want_tokens = (np.asarray(a) for a in net.apply(variables, clip))
    enc = load_variables(VideoEncoder("videomae_tiny", 64, num_tokens=tokens, use_flash=use_flash), variables)
    with torch.inference_mode():
        emb, got_tokens = enc(torch.from_numpy(clip))
    assert emb.shape == (2, 64) and got_tokens.shape == (2, tokens, 64)
    np.testing.assert_allclose(got_tokens.numpy(), want_tokens, atol=ATOL, rtol=0)
    np.testing.assert_allclose(emb.numpy(), want_emb, atol=ATOL, rtol=0)


def test_vit_fold_normalization_matches_jax():
    """The tubelet kernel scaled per input channel and ``bias += δ``, as JAX folds it."""
    _, variables, _ = _encoder(32, True, 7)
    tree = {"params": {"video_encoder": variables["params"]}}
    got, changed = fold_normalization(tree, vit_config())
    want, want_changed = jax_fold_normalization(tree, vit_config())
    assert changed and want_changed
    g, w = dict(_flatten(got)), dict(_flatten(jax.device_get(want)))
    assert g.keys() == w.keys()
    for key in g:
        np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=1e-5, err_msg="/".join(key))
    proj = ("params", "video_encoder", "vit", "tubelet", "proj")
    assert not np.array_equal(g[proj + ("bias",)], dict(_flatten(tree))[proj + ("bias",)])
    untouched = ("params", "video_encoder", "vit", "block0", "mlp_in", "kernel")
    assert g[untouched] is dict(_flatten(tree))[untouched]


def test_init_params_matches_flax_init_of_vit_config():
    """``init_params(vit_config())`` has flax's tree paths and leaf shapes (JAX's
    ``model.init`` traced for shapes only), and the ViT ``pos_encoding`` is flax's
    normal(0.02) while the IMU encoder's stays normal(1.0)."""
    from tpuhar.models.crossmodal import FusionClassifier as JaxFusionClassifier

    cfg = vit_config()
    d = cfg.data
    shapes = jax.eval_shape(
        JaxFusionClassifier(cfg).init,
        jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, d.imu_channels, d.imu_window_size), jnp.float32),
        jax.ShapeDtypeStruct((1, d.video_frames_per_window, *d.video_resize, 3), jnp.float32),
    )
    want = {k: tuple(v.shape) for k, v in _flatten(shapes)}
    ours = dict(_flatten(init_params(cfg, torch.Generator().manual_seed(0))))
    assert {k: v.shape for k, v in ours.items()} == want
    pos = ours[("params", "video_encoder", "vit", "pos_encoding")]
    assert pos.shape == (1, 1568, 768) and abs(pos.std() - 0.02) < 1e-3
    assert abs(ours[("params", "imu_encoder", "pos_encoding")].std() - 1.0) < 0.05
    qk = ours[("params", "video_encoder", "vit", "block0", "self_attn", "query", "kernel")]
    assert abs(qk.std() * np.sqrt(768) - 1.0) < 0.01  # lecun over the (768, 768) matrix


def test_hf_backbone_names_map_onto_the_native_vit():
    """Quirk Q10: a name holding "videomae" or "/" outside ``VIT_CONFIGS`` builds
    ``videomae_base``, as JAX's ``build_video_encoder`` does; the ladder's own names
    keep their sizes."""
    from tpuhar_torch.models.video import build_video_encoder

    cfg = vit_config()
    for name, (depth, width) in {
        "MCG-NJU/videomae-base-finetuned-kinetics": (12, 768),
        "videomae_small": (12, 384),
    }.items():
        cfg.model.video_backbone = name
        with torch.device("meta"):
            enc = build_video_encoder(cfg, torch.float32)
        assert enc.vit.depth == depth and enc.vit.pos_encoding.shape == (1, 1568, width)
    cfg.model.video_backbone = "resnet18"  # a CNN tower's name maps onto no ViT
    with torch.device("meta"):
        assert not build_video_encoder(cfg, torch.float32).is_vit
