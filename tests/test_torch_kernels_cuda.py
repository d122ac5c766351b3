"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA device. On a machine with
one (and nvcc), from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the tests' conftest imports JAX, which the GPU machine need not
have; this file imports none.)
"""
import numpy as np
import pytest
import torch

from tpuhar_torch.ops.conv3x3 import conv3x3_bn_act, conv3x3_bn_act_reference
from tpuhar_torch.ops.featurize import featurize_windows
from tpuhar_torch.ops.fused_window import featurize_windows_auto

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "kw",
    [{}, {"kernel_size": 1}, {"kernel_size": 4}, {"normalize": False}, {"racc": 100.0, "rgyro": 2.0}],
)
@pytest.mark.parametrize("B,T", [(256, 250), (3, 128), (1, 1000)])
def test_fused_window_matches_plain(cuda, B, T, kw):
    raw = torch.from_numpy(np.random.default_rng(B).normal(0, 8000, (B, T, 6)).astype(np.float32)).to(cuda)
    before = featurize_windows_auto.launches
    got = featurize_windows_auto(raw, **kw)
    assert featurize_windows_auto.launches == before + 1
    torch.testing.assert_close(got, featurize_windows(raw, **kw), rtol=0, atol=1e-5)


def test_fused_window_refuses(cuda):
    raw = torch.zeros((2, 250, 6), device=cuda)
    with pytest.raises(NotImplementedError):
        featurize_windows_auto(raw, kernel_size=3)
    with pytest.raises(ValueError):
        featurize_windows_auto(raw.double())
    with pytest.raises(ValueError):
        featurize_windows_auto(raw.transpose(0, 1).contiguous().transpose(0, 1))


def _conv_case(n, s, c, c_out, residual, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.relu(torch.randn((n, s, s, c), generator=gen, device=device)).to(torch.bfloat16)
    k = (torch.randn((3, 3, c, c_out), generator=gen, device=device) * (9 * c) ** -0.5).to(torch.bfloat16)
    scale = torch.rand(c_out, generator=gen, device=device) + 0.5
    bias = torch.randn(c_out, generator=gen, device=device) * 0.1
    res = torch.randn((n, s, s, c_out), generator=gen, device=device).to(torch.bfloat16) if residual else None
    return x, k, scale, bias, res


@pytest.mark.parametrize(
    "n,s,c,c_out,residual,relu",
    [
        (16, 14, 256, 256, False, True),
        (16, 14, 256, 256, True, True),
        (16, 7, 512, 512, True, True),
        (3, 7, 512, 512, True, False),  # M = 147: a ragged last row tile
        (2, 5, 48, 80, False, True),  # C and C_out multiples of 16, not of the tiles
        (5, 15, 128, 128, True, True),
    ],
)
def test_conv3x3_matches_plain(cuda, n, s, c, c_out, residual, relu):
    x, k, scale, bias, res = _conv_case(n, s, c, c_out, residual, cuda)
    before = conv3x3_bn_act.launches
    got = conv3x3_bn_act(x, k, scale, bias, residual=res, relu=relu)
    assert conv3x3_bn_act.launches == before + 1
    want = conv3x3_bn_act_reference(x, k, scale, bias, res, relu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    rel = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert rel.item() <= 2e-2


def test_conv3x3_frames_do_not_leak(cuda):
    """Each frame's conv equals the same conv run on that frame alone."""
    x, k, scale, bias, _ = _conv_case(4, 7, 128, 128, False, cuda, seed=1)
    whole = conv3x3_bn_act(x, k, scale, bias)
    for i in range(4):
        torch.testing.assert_close(whole[i : i + 1], conv3x3_bn_act(x[i : i + 1].contiguous(), k, scale, bias), rtol=0, atol=0)


def test_conv3x3_refuses(cuda):
    x, k, scale, bias, _ = _conv_case(2, 7, 128, 128, False, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        conv3x3_bn_act(x.float(), k.float(), scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_bn_act(x.transpose(1, 2), k, scale, bias)
    with pytest.raises(ValueError, match="multiples of 16"):
        conv3x3_bn_act(x[..., :120].contiguous(), k[:, :, :120].contiguous(), scale, bias)
    with pytest.raises(ValueError, match="square"):
        conv3x3_bn_act(x[:, :6].contiguous(), k, scale, bias)


def test_slice_on_card_matches_cpu_f32(cuda):
    """The flagship forward cut to test size: bf16 on the card vs f32 on the CPU, same
    parameters; both kernels are launched."""
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.entry import build_forward, flagship_config
    from tpuhar_torch.ops.stem import to_patch_major

    cfg = flagship_config()
    cfg.data.video_resize, cfg.data.video_frames_per_window = (64, 64), 4
    params = init_params(cfg, torch.Generator().manual_seed(0))
    fn, _ = build_forward(cfg, 2, device=cuda, params=params)
    cfg32 = flagship_config("float32")
    cfg32.data.video_resize, cfg32.data.video_frames_per_window = (64, 64), 4
    ref_fn, _ = build_forward(cfg32, 2, device="cpu", params=params)
    rng = np.random.default_rng(0)
    imu = torch.from_numpy(rng.normal(0, 8000, (2, 250, 6)).astype(np.float32))
    video = torch.from_numpy(to_patch_major(rng.integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)))
    before = featurize_windows_auto.launches, conv3x3_bn_act.launches
    got = fn(imu.to(cuda), video.to(cuda))
    assert featurize_windows_auto.launches == before[0] + 1
    assert conv3x3_bn_act.launches == before[1] + 4
    want = ref_fn(imu, video)
    for key in ("logits", "embeddings"):
        cos = torch.nn.functional.cosine_similarity(got[key].cpu().flatten(), want[key].flatten(), dim=0)
        assert cos.item() >= 0.99, key
