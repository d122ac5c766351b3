"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA device. On a machine with
one (and nvcc), from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the tests' conftest imports JAX, which the GPU machine need not
have; this file imports none.)
"""
import contextlib

import numpy as np
import pytest
import torch

from tpuhar_torch.ops.conv3x3 import (
    conv3x3_bn_act,
    conv3x3_bn_act_f32,
    conv3x3_bn_act_reference,
    conv3x3_i8,
    conv3x3_i8_reference,
)
from tpuhar_torch.ops.featurize import featurize_windows
from tpuhar_torch.ops.fused_window import featurize_windows_auto
from tpuhar_torch.ops.stem import int8_gemm, int8_gemm_reference, stem_gemm_u8, stem_gemm_u8_reference, verify_byte_map

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


# every kernel size the plain version takes (even ones bump to the next odd one; 0 and 1
# are no filter), on the default window, a window past one 1024-sample tile, and a ragged
# last tile whose medians reach across the tile's edge
@pytest.mark.parametrize("k", [0, 2, 3, 7, 9, 31])
@pytest.mark.parametrize("B,T", [(4, 250), (3, 2048), (2, 1500)])
def test_fused_window_any_kernel_size_and_length(cuda, B, T, k):
    raw = torch.from_numpy(np.random.default_rng(T + k).normal(0, 8000, (B, T, 6)).astype(np.float32)).to(cuda)
    before = featurize_windows_auto.launches
    got = featurize_windows_auto(raw, kernel_size=k)
    assert featurize_windows_auto.launches == before + 1
    torch.testing.assert_close(got, featurize_windows(raw, kernel_size=k), rtol=0, atol=1e-5)


def test_fused_window_ties_and_zero_pads(cuda):
    """Repeated values and windows shorter than the median: the rank search and the
    implicit zero pads pick the plain version's median exactly."""
    rng = np.random.default_rng(7)
    raw = torch.from_numpy(rng.integers(-3, 4, (5, 9, 6)).astype(np.float32) * 1000).to(cuda)
    for k in (3, 5, 7, 11, 25):
        torch.testing.assert_close(
            featurize_windows_auto(raw, kernel_size=k, normalize=False),
            featurize_windows(raw, kernel_size=k, normalize=False), rtol=0, atol=0,
        )


def _windows(B, T, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 8000, (B, T, 6)).astype(np.float32)).to(device)


def _featurize_matches_plain(raw, **kw):
    before = featurize_windows_auto.launches
    got = featurize_windows_auto(raw, **kw)
    assert featurize_windows_auto.launches == before + 1
    torch.testing.assert_close(got, featurize_windows(raw, **kw), rtol=0, atol=1e-5)


# the serving shape at one window, the latency batch and a batch whose 98 MB a call
# exceed the L2 cache
@pytest.mark.parametrize("B", [1, 8, 8192])
def test_fused_window_serving_batches(cuda, B):
    _featurize_matches_plain(_windows(B, 250, B, cuda))


# both edges of the register form (T <= 1024, a lane's samples rounded up to a power of
# two) and the tiled form just past it, at the filters of each code path
@pytest.mark.parametrize("k", [0, 3, 5, 9, 31])
@pytest.mark.parametrize("T", [31, 32, 33, 1023, 1024, 1025])
def test_fused_window_form_edges(cuda, T, k):
    _featurize_matches_plain(_windows(3, T, T + k, cuda), kernel_size=k)


# odd T: every other window starts 8 bytes off a 16-byte boundary, and the 16-byte body
# of each is framed by a scalar head and tail
@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("T", [1, 3, 7, 249, 251, 1001])
def test_fused_window_odd_lengths(cuda, T, k):
    """The scaled median, exact in f32, equals the plain version's bit for bit. The
    z-score is held against float64 on those medians: its f32 error is that of the mean,
    at most (T / 32 + 6) roundings of the largest sample (each lane's sum, then five
    shuffle folds and the division), over the std. That is 1e-5 where the samples spread,
    and more in a short window whose medians nearly agree (T = 3, k = 3 gives a channel
    of 223.4142, 223.4142, 221.8524, whose z-score any f32 order misses by ~2e-5)."""
    raw = _windows(5, T, T * k, cuda)
    m = featurize_windows_auto(raw, kernel_size=k, normalize=False)
    torch.testing.assert_close(m, featurize_windows(raw, kernel_size=k, normalize=False), rtol=0, atol=0)
    z = featurize_windows_auto(raw, kernel_size=k).double()
    m = m.double()
    std = m.std(-1, correction=0, keepdim=True)
    want = (m - m.mean(-1, keepdim=True)) / (std + 1e-8)
    tol = 1e-5 + (T / 32 + 6) * 2.0**-24 * m.abs().amax(-1, keepdim=True) / (std + 1e-8)
    assert ((z - want).abs() <= tol).all(), ((z - want).abs() / tol).max().item()


# a base 4, 8 and 12 bytes past a 16-byte boundary: a contiguous view into a flat buffer
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("T", [250, 251, 2048])
def test_fused_window_unaligned_base(cuda, T, offset):
    raw = _windows(4, T, offset, cuda)
    flat = torch.empty(offset + raw.numel(), device=cuda)
    view = flat[offset:].view(raw.shape)
    view.copy_(raw)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset
    _featurize_matches_plain(view)
    torch.testing.assert_close(featurize_windows_auto(view), featurize_windows_auto(raw), rtol=0, atol=0)


def test_fused_window_in_a_cuda_graph(cuda):
    """Captured in a CUDA graph and replayed on new input, the kernel gives the eager
    call's output bit for bit."""
    raw = _windows(256, 250, 11, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        featurize_windows_auto(raw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = featurize_windows_auto(raw)
    raw.copy_(_windows(256, 250, 12, cuda))
    before = featurize_windows_auto.launches
    graph.replay()
    torch.cuda.synchronize()
    assert featurize_windows_auto.launches == before  # a replay calls no wrapper
    torch.testing.assert_close(captured, featurize_windows_auto(raw), rtol=0, atol=0)


def test_fused_window_refuses(cuda):
    raw = torch.zeros((2, 250, 6), device=cuda)
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
        # the four convs of the bf16 tower at batch 8 and 256 (16 frames a clip)
        (128, 14, 256, 256, False, True),
        (128, 14, 256, 256, True, True),
        (128, 7, 512, 512, False, True),
        (128, 7, 512, 512, True, True),
        (4096, 14, 256, 256, False, True),
        (4096, 14, 256, 256, True, True),
        (4096, 7, 512, 512, False, True),
        (4096, 7, 512, 512, True, True),
        (3, 7, 512, 512, True, False),  # M = 147: a ragged second row tile
        (3, 7, 512, 512, False, False),
        (3, 14, 256, 256, True, True),  # M = 588 = 4·128 + 76
        (3, 14, 256, 256, False, False),
        (1, 7, 64, 64, False, False),  # less than one warpgroup's 64 rows
        (2, 5, 64, 80, False, True),  # C_out a multiple of 8, not of the 64-column boxes
        (300, 7, 64, 320, True, True),  # two column tiles, the second ragged
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


@pytest.mark.parametrize(
    "n,s,c,c_out,residual,relu",
    [
        # the tpu_cnn tower of the dry run's int8 engine, in f32: 2² maps at 256 channels,
        # 1² at 512 (8 frames a rank), with and without the residual
        (8, 2, 256, 256, False, True),
        (8, 2, 256, 256, True, True),
        (16, 1, 512, 512, True, True),
        (3, 7, 48, 40, False, False),  # any C and C_out
        (2, 14, 256, 256, True, True),
        (2, 5, 3, 7, True, True),  # C not a multiple of 4 (4-byte gathers), C_out odd (scalar stores)
        (3, 9, 130, 131, True, False),  # C past a 32-channel chunk, C_out past a 128-column tile
        # the f32 flagship's four convs at batch 4 (64 frames of 14² and 7²)
        (64, 14, 256, 256, False, True),
        (64, 14, 256, 256, True, True),
        (64, 7, 512, 512, False, True),
        (64, 7, 512, 512, True, True),
    ],
)
def test_conv3x3_f32_matches_plain(cuda, n, s, c, c_out, residual, relu):
    x, k, scale, bias, res = (t if t is None else t.float() for t in _conv_case(n, s, c, c_out, residual, cuda))
    before = conv3x3_bn_act_f32.launches, conv3x3_bn_act.launches
    got = conv3x3_bn_act(x, k, scale, bias, residual=res, relu=relu)
    assert (conv3x3_bn_act_f32.launches, conv3x3_bn_act.launches) == (before[0] + 1, before[1])
    want = conv3x3_bn_act_reference(x.double(), k.double(), scale, bias, None if res is None else res.double(), relu)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ((got.double() - want).abs().max() / want.abs().max()).item() <= 1e-5


def test_conv3x3_f32_frames_do_not_leak(cuda):
    """Each frame's f32 conv equals the same conv run on that frame alone: a 128-row
    tile spans frames, and no tap reaches across a frame's edge."""
    x, k, scale, bias, res = (t.float() for t in _conv_case(4, 7, 128, 128, True, cuda, seed=1))
    whole = conv3x3_bn_act(x, k, scale, bias, residual=res)
    for i in range(4):
        alone = conv3x3_bn_act(x[i : i + 1].contiguous(), k, scale, bias, residual=res[i : i + 1].contiguous())
        torch.testing.assert_close(whole[i : i + 1], alone, rtol=0, atol=0)


def test_conv3x3_refuses(cuda):
    x, k, scale, bias, _ = _conv_case(2, 7, 128, 128, False, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        conv3x3_bn_act(x.half(), k.half(), scale, bias)
    with pytest.raises(ValueError, match="float32"):
        conv3x3_bn_act(x.float(), k, scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_bn_act(x.transpose(1, 2), k, scale, bias)
    with pytest.raises(ValueError, match="multiple of 64"):
        conv3x3_bn_act(x[..., :120].contiguous(), k[:, :, :120].contiguous(), scale, bias)
    with pytest.raises(ValueError, match="square"):
        conv3x3_bn_act(x[:, :6].contiguous(), k, scale, bias)


# the conv forms the towers and the IMU 1-D CNN train and serve through (cuDNN on the
# card): (name, x shape, kernel shape, stride, padding, groups, bias)
CONV_FORMS = {
    "resnet_stride2_pad_1_1": ((16, 56, 56, 64), (3, 3, 64, 128), 2, [(1, 1), (1, 1)], 1, False),
    "resnet_stem_7x7": ((8, 224, 224, 3), (7, 7, 3, 64), 2, [(3, 3), (3, 3)], 1, False),
    "downsample_1x1_stride2": ((16, 56, 56, 64), (1, 1, 64, 128), 2, "SAME", 1, False),
    "mobilenet_depthwise": ((16, 28, 28, 144), (3, 3, 1, 144), 2, [(1, 1), (1, 1)], 144, False),
    "tiny_cnn_bias_same": ((16, 33, 33, 16), (3, 3, 16, 32), 2, "SAME", 1, True),
    "imu_1d_same_3_4": ((64, 250, 6), (9, 6, 64), 2, "SAME", 1, True),
}


@pytest.mark.parametrize("form", list(CONV_FORMS))
def test_conv_forms_match_the_cpu(cuda, form):
    """Each conv form of ``conv_nhwc``/``conv_nlc`` (explicit (lo, hi) pads, groups, a bias,
    the 1-D conv with XLA's uneven SAME pads) on the card against the CPU on the same f32
    inputs: within 1e-5 of the largest output (TF32 off)."""
    from tpuhar_torch.ops.conv3x3 import conv_nhwc, conv_nlc

    x_shape, k_shape, stride, padding, groups, with_bias = CONV_FORMS[form]
    gen = torch.Generator().manual_seed(len(form))
    x, k = torch.randn(x_shape, generator=gen), torch.randn(k_shape, generator=gen)
    bias = torch.randn(k_shape[-1], generator=gen) if with_bias else None

    def conv(x, k, bias):
        if x.dim() == 3:
            return conv_nlc(x, k, stride, padding, bias=bias)
        return conv_nhwc(x, k, stride, padding, groups=groups, bias=bias)

    want = conv(x, k, bias)
    got = conv(x.to(cuda), k.to(cuda), None if bias is None else bias.to(cuda))
    assert got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_max_pool_matches_the_cpu(cuda):
    from tpuhar_torch.ops.conv3x3 import max_pool_nhwc

    x = torch.randn((16, 112, 112, 64), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(max_pool_nhwc(x.to(cuda), 3, 2, 1).cpu(), max_pool_nhwc(x, 3, 2, 1), rtol=0, atol=0)


def _stem_case(frames, c0, device, seed=0, k=768):
    gen = torch.Generator(device=device).manual_seed(seed)
    col = torch.randint(0, 256, (frames, 14, 14, k), generator=gen, device=device, dtype=torch.uint8)
    col[0, :2] = 0  # pure-black pixels: the u8 = 0 → -127 clip corner
    w = torch.randint(-127, 128, (c0, k), generator=gen, device=device, dtype=torch.int8)  # K-major
    scale = torch.rand(c0, generator=gen, device=device) * 1e-5  # most codes inside ±127
    bias = torch.randn(c0, generator=gen, device=device) * 0.5
    return col, w, scale, bias


@pytest.mark.parametrize(
    "frames,c0,k,zero_frames",
    [
        (128, 256, 768, 0),  # the int8-resident stem at batch 8
        (3, 256, 768, 0),  # M = 588: a ragged last row tile
        (3, 64, 768, 0),  # C0 below one 256-wide tile
        (3, 160, 768, 0),
        (3, 256, 192, 0),  # K = 192: the second 128-byte chunk half past K (u8 0 maps to -127)
        (4, 256, 768, 2),  # whole 128-row tiles of pure-black pixels
    ],
)
@pytest.mark.parametrize("out_scale", [None, 0.05])
@pytest.mark.parametrize("relu", [True, False])
def test_stem_u8_matches_plain_exactly(cuda, frames, c0, k, zero_frames, out_scale, relu):
    col, w, scale, bias = _stem_case(frames, c0, cuda, k=k)
    col[:zero_frames] = 0
    before = stem_gemm_u8.launches
    got = stem_gemm_u8(col, w, scale, bias, relu=relu, out_scale=out_scale)
    assert stem_gemm_u8.launches == before + 1
    want = stem_gemm_u8_reference(col, w, scale, bias, relu=relu, out_scale=out_scale)
    assert got.dtype == want.dtype == (torch.float32 if out_scale is None else torch.int8)
    assert got.shape == want.shape == (frames, 14, 14, c0)
    assert torch.equal(got, want)


def test_stem_u8_byte_map_preflight(cuda):
    before = stem_gemm_u8.launches
    verify_byte_map(cuda)
    assert stem_gemm_u8.launches == before + 1


def test_stem_u8_refuses(cuda):
    col, w, scale, bias = _stem_case(2, 64, cuda)
    # int8 input is the centered wire: the codes go through the int8 GEMM kernel as they are
    codes = col.view(torch.int8)
    before = stem_gemm_u8.launches, int8_gemm.launches
    got = stem_gemm_u8(codes, w, scale, bias, out_scale=0.05)
    assert (stem_gemm_u8.launches, int8_gemm.launches) == (before[0], before[1] + 1)
    assert torch.equal(got, stem_gemm_u8_reference(codes, w, scale, bias, out_scale=0.05))
    with pytest.raises(TypeError, match="uint8 patch-major pixels"):
        stem_gemm_u8(col.float(), w, scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        stem_gemm_u8(col.transpose(1, 2), w, scale, bias)
    with pytest.raises(ValueError, match="int8"):
        stem_gemm_u8(col, w.float(), scale, bias)
    with pytest.raises(ValueError, match="multiple"):
        stem_gemm_u8(col, w[:48].contiguous(), scale[:48], bias[:48])
    with pytest.raises(ValueError, match="do not match"):
        stem_gemm_u8(col[..., :640].contiguous(), w, scale, bias)
    with pytest.raises(ValueError, match=r"K-major \(C0, K\) expected"):
        stem_gemm_u8(col, w.T.contiguous(), scale, bias)


def _gemm_case(m, k, n, device, seed=0):
    """Full-range int8 codes and weights: at K = 3072 |acc| reaches 4.9e7 > 2^24, where
    the int32 -> f32 convert rounds."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)  # K-major
    scale = torch.rand(n, generator=gen, device=device) * 1e-6
    bias = torch.randn(n, generator=gen, device=device) * 0.5
    return x, w, scale, bias


@pytest.mark.parametrize(
    "m,k,n",
    [
        (12544, 768, 2304),  # the int8 ViT at batch 8: qkv (9 tiles of 256), out, mlp_in, mlp_out
        (12544, 768, 768),
        (12544, 768, 3072),
        (12544, 3072, 768),
        (100352, 192, 64),  # ResNet-18's stem rows (K 147 padded to 192: a partial
        # 128-byte chunk) and a narrow output, a quarter of one tile
        (100352, 64, 128),  # a downsample: one 64-byte K chunk
        (1000, 192, 64),  # ragged M
        (77, 128, 96),
    ],
)
@pytest.mark.parametrize("out_scale", [None, 0.05])
def test_int8_gemm_matches_plain_exactly(cuda, m, k, n, out_scale):
    x, w, scale, bias = _gemm_case(m, k, n, cuda)
    for relu in (False, True):
        before = int8_gemm.launches
        got = int8_gemm(x, w, scale, bias, relu=relu, out_scale=out_scale)
        assert int8_gemm.launches == before + 1
        want = int8_gemm_reference(x, w, scale, bias, relu=relu, out_scale=out_scale)
        assert got.dtype == want.dtype == (torch.float32 if out_scale is None else torch.int8)
        assert got.shape == want.shape == (m, n)
        assert torch.equal(got, want)


def test_int8_gemm_zero_fill_past_k_stays_zero(cuda):
    """K = 192 with the codes past 147 zero, as ResNet-18's stem rows are: the second
    chunk's zero fill adds 0 (the u8 form's map would make it -127, against zero
    weights), and the codes' own zeros stay zeros."""
    x, w, scale, bias = _gemm_case(3000, 192, 64, cuda)
    x[:, 147:] = 0
    w[:, 147:] = 0
    want = int8_gemm_reference(x[:, :147].contiguous(), w[:, :147].contiguous(), scale, bias, relu=True)
    assert torch.equal(int8_gemm(x, w, scale, bias, relu=True), want)


def test_int8_gemm_refuses(cuda):
    x, w, scale, bias = _gemm_case(64, 192, 64, cuda)
    with pytest.raises(ValueError, match="int8"):
        int8_gemm(x.view(torch.uint8), w, scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        int8_gemm(x.T, w[:, :64].contiguous(), scale, bias)
    with pytest.raises(ValueError, match="multiple of 64"):
        int8_gemm(x[:, :147].contiguous(), w[:, :147].contiguous(), scale, bias)
    with pytest.raises(ValueError, match=r"K-major \(C0, K\) expected"):
        int8_gemm(x, w.T.contiguous(), scale, bias)
    with pytest.raises(ValueError, match="positive"):
        int8_gemm(x, w, scale, bias, out_scale=0.0)


def _conv_i8_case(n, s, c, c_out, stride, residual, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    so = -(-s // stride)
    x = torch.randint(0, 128, (n, s, s, c), generator=gen, device=device, dtype=torch.int8)
    w = torch.randint(-127, 128, (c_out, 9 * c), generator=gen, device=device, dtype=torch.int8)
    scale = torch.rand(c_out, generator=gen, device=device) * 1e-5  # most codes inside ±127
    bias = torch.randn(c_out, generator=gen, device=device) * 0.1
    res = torch.randint(0, 128, (n, so, so, c_out), generator=gen, device=device, dtype=torch.int8) if residual else None
    return x, w, scale, bias, res


@pytest.mark.parametrize(
    "n,s,c,c_out,stride,residual,out_scale",
    [
        (128, 14, 256, 256, 1, False, 0.02),  # s0 block a
        (128, 14, 256, 256, 1, True, 0.02),  # s0 block b
        (128, 14, 256, 512, 2, False, 0.02),  # down1
        (128, 7, 512, 512, 1, False, 0.02),  # s1 block a
        (128, 7, 512, 512, 1, True, None),  # s1 block b: f32 out
        (4096, 14, 256, 256, 1, False, 0.02),  # the same five at batch 256
        (4096, 14, 256, 256, 1, True, 0.02),
        (4096, 14, 256, 512, 2, False, 0.02),
        (4096, 7, 512, 512, 1, False, 0.02),
        (4096, 7, 512, 512, 1, True, None),
        (3, 7, 512, 512, 1, True, 0.02),  # M = 147: a ragged last row tile
        (3, 14, 256, 512, 2, False, 0.02),  # ragged M at stride 2
        (3, 7, 160, 288, 1, True, 0.02),  # a partial 128-byte row of C; a partial 256-wide B box
        (3, 7, 160, 288, 1, False, None),
        (2, 5, 96, 160, 2, True, None),  # odd plane at stride 2; C not a multiple of 64
        (4, 9, 32, 32, 1, False, None),
    ],
)
def test_conv3x3_i8_matches_plain_exactly(cuda, n, s, c, c_out, stride, residual, out_scale):
    x, w, scale, bias, res = _conv_i8_case(n, s, c, c_out, stride, residual, cuda)
    kw = dict(stride=stride, residual=res, res_scale=0.01 if residual else None, out_scale=out_scale)
    for relu in (True, False):
        before = conv3x3_i8.launches
        got = conv3x3_i8(x, w, scale, bias, relu=relu, **kw)
        assert conv3x3_i8.launches == before + 1
        want = conv3x3_i8_reference(x, w, scale, bias, relu=relu, **kw)
        assert got.dtype == want.dtype == (torch.float32 if out_scale is None else torch.int8)
        assert got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize(
    "n,s,c,c_out,stride,residual,out_scale",
    [
        (8, 56, 64, 128, 2, False, 0.02),  # ResNet-18's layer1_0 conv1 (SAME would pad (0, 1))
        (128, 56, 64, 128, 2, False, None),
        (8, 28, 128, 256, 2, False, 0.02),
        (8, 14, 256, 512, 2, False, 0.02),
        (8, 56, 64, 64, 1, True, 0.02),  # an identity block's conv2
        (3, 7, 512, 512, 1, True, None),
        (2, 9, 64, 96, 2, False, None),  # an odd plane: (1, 1) is SAME there
    ],
)
def test_conv3x3_i8_explicit_padding_matches_plain(cuda, n, s, c, c_out, stride, residual, out_scale):
    x, w, scale, bias, res = _conv_i8_case(n, s, c, c_out, stride, residual, cuda)
    kw = dict(stride=stride, padding=[(1, 1), (1, 1)], residual=res, res_scale=0.01 if residual else None,
              out_scale=out_scale)
    before = conv3x3_i8.launches
    got = conv3x3_i8(x, w, scale, bias, **kw)
    assert conv3x3_i8.launches == before + 1
    want = conv3x3_i8_reference(x, w, scale, bias, **kw)
    assert got.shape == want.shape == (n, -(-s // stride), -(-s // stride), c_out)
    assert torch.equal(got, want)
    if stride == 2 and s % 2 == 0:  # SAME is another conv on an even plane
        assert not torch.equal(conv3x3_i8(x, w, scale, bias, **{**kw, "padding": "SAME"}), want)


def test_conv3x3_i8_refuses_another_output_side(cuda):
    x, w, scale, bias, _ = _conv_i8_case(2, 8, 64, 64, 1, False, cuda)
    for padding, match in (("VALID", "side of 6"), ([(2, 2), (2, 2)], "side of 10"), ([(1, 1), (0, 2)], "alike")):
        with pytest.raises(ValueError, match=match):
            conv3x3_i8(x, w, scale, bias, padding=padding)


def test_conv3x3_i8_refuses(cuda):
    x, w, scale, bias, _ = _conv_i8_case(2, 7, 64, 64, 1, False, cuda)
    with pytest.raises(ValueError, match="int8"):
        conv3x3_i8(x.float(), w, scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_i8(x.transpose(1, 2), w, scale, bias)
    with pytest.raises(ValueError, match="multiples of 32"):
        conv3x3_i8(x[..., :48].contiguous(), w[:, : 9 * 48].contiguous(), scale, bias)
    with pytest.raises(ValueError, match="square"):
        conv3x3_i8(x[:, :6].contiguous(), w, scale, bias)
    with pytest.raises(ValueError, match="stride"):
        conv3x3_i8(x, w, scale, bias, stride=3)
    with pytest.raises(ValueError, match="res_scale"):
        conv3x3_i8(x, w, scale, bias, residual=x)


def test_int8_slice_on_card_matches_cpu(cuda):
    """The int8-resident forward cut to test size: the card's kernels against the
    plain CPU path on the same quantized tree and logit map. The int8 tower features
    agree to f32 sum order; the bf16 fusion stack to its cosine bound."""
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.entry import build_int8_forward, flagship_config
    from tpuhar_torch.ops.quant import quant_tpucnn_forward_resident, tree_to
    from tpuhar_torch.ops.stem import to_patch_major
    from tpuhar_torch.serving_quant import quantized_forward

    cfg = flagship_config()
    cfg.data.video_resize, cfg.data.video_frames_per_window = (64, 64), 4
    params = init_params(cfg, torch.Generator().manual_seed(0))
    fn, _ = build_int8_forward(cfg, 2, device=cuda, params=params)
    rng = np.random.default_rng(0)
    imu = torch.from_numpy(rng.normal(0, 8000, (2, 250, 6)).astype(np.float32))
    video = torch.from_numpy(to_patch_major(rng.integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)))
    before = featurize_windows_auto.launches, stem_gemm_u8.launches, conv3x3_i8.launches
    got = fn(imu.to(cuda), video.to(cuda))
    after = featurize_windows_auto.launches, stem_gemm_u8.launches, conv3x3_i8.launches
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 5)

    q_cpu = tree_to(fn.quantized_tree, "cpu")
    frames = video.reshape(8, 4, 4, 768)
    feats_card = quant_tpucnn_forward_resident(fn.quantized_tree, frames.to(cuda)).cpu()
    feats_cpu = quant_tpucnn_forward_resident(q_cpu, frames)
    torch.testing.assert_close(feats_card, feats_cpu, rtol=1e-5, atol=1e-6)

    from tpuhar_torch.models.crossmodal import FusionClassifier
    from tpuhar_torch.bridge import load_variables

    cfg32 = flagship_config("float32")
    cfg32.data.video_resize, cfg32.data.video_frames_per_window = (64, 64), 4
    model = load_variables(FusionClassifier(cfg32), params).eval()
    ref_fn = quantized_forward(
        cfg32, model, q_cpu, params["params"]["video_encoder"]["projection"],
        device="cpu", recalibration=fn.recalibration, resident=True,
    )
    want = ref_fn(imu, video)
    for key in ("logits", "embeddings"):
        cos = torch.nn.functional.cosine_similarity(got[key].cpu().flatten(), want[key].flatten(), dim=0)
        assert cos.item() >= 0.99, key


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


def _attention_case(B, H, N, device, seed=0, dtype=torch.bfloat16, strided=False):
    """q, k, v as (B, H, N, 64): contiguous, or the views of (B, N, H, 64) buffers that
    the ViT's attention hands over."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if strided:
        return [torch.randn((B, N, H, 64), generator=gen, device=device).to(dtype).transpose(1, 2) for _ in range(3)]
    return [torch.randn((B, H, N, 64), generator=gen, device=device).to(dtype) for _ in range(3)]


# N: one token, below one 112-row key tile, ragged, whole key tiles (112, 224), whole
# query tiles (192, 384), 128 and 256 (two and four warpgroups' rows), and videomae_base's
# 1568 = 14 key tiles = 8.17 query tiles
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
@pytest.mark.parametrize("B,H", [(1, 1), (2, 3), (8, 12)])
@pytest.mark.parametrize("N", [1, 8, 32, 100, 112, 128, 192, 224, 256, 384, 1568])
def test_flash_lean_matches_plain(cuda, B, H, N, strided):
    """bf16 against the plain one-tile math: max |kernel − plain| / max |plain| ≤ 1e-2,
    since the online rescale reorders the sums and each tile's P rounds to bf16 against
    another running max."""
    from tpuhar_torch.ops.flash_lean import flash_lean, flash_lean_reference

    q, k, v = _attention_case(B, H, N, cuda, strided=strided)
    assert q.is_contiguous() != strided or min(H, N) == 1
    before = flash_lean.launches
    got = flash_lean(q, k, v)
    assert flash_lean.launches == before + 1
    want = flash_lean_reference(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (B, H, N, 64)
    rel = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert rel.item() <= 1e-2


def test_flash_lean_reads_strided_projections(cuda):
    """Views of one (B, N, 3·H·64) projection give what contiguous copies give."""
    from tpuhar_torch.ops.flash_lean import flash_lean

    B, N, H = 2, 197, 12
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((B, N, 3 * H * 64), generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = (t.view(B, N, H, 64).transpose(1, 2) for t in qkv.split(H * 64, dim=-1))
    assert not q.is_contiguous()
    strided = flash_lean(q, k, v)
    contiguous = flash_lean(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(strided, contiguous)
    assert strided.transpose(1, 2).is_contiguous()  # the (B, N, H, 64) buffer


def test_flash_lean_refuses(cuda):
    from tpuhar_torch.ops.flash_lean import flash_lean

    q, k, v = _attention_case(1, 2, 64, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_lean(q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous())
    got = flash_lean(q.float(), k.float(), v.float())  # f32 goes to the f32 kernel, nothing is cast
    assert got.dtype == torch.float32 and got.shape == q.shape
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash_lean(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="k must be a torch.bfloat16 tensor"):  # one type for all three
        flash_lean(q, k.float(), v)
    with pytest.raises(ValueError, match="unit stride"):
        flash_lean(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    wide = torch.zeros((1, 2, 64, 72), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):  # rows start 8 bytes off
        flash_lean(wide[..., 4:68], k, v)
    with pytest.raises(ValueError, match="multiples of 8"):  # a token stride of 68 elements
        flash_lean(torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16, device=cuda)[..., :64], k, v)
    with pytest.raises(ValueError, match="broadcast"):
        flash_lean(q[:, :1].expand(1, 2, 64, 64), k, v)
    for sm_scale in (0.0, -0.125):  # the kernel takes the max of the raw scores
        with pytest.raises(ValueError, match="positive"):
            flash_lean(q, k, v, sm_scale=sm_scale)


F32_RTOL = 1e-5  # of the largest element: the same f32 function, its sums in another order


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
@pytest.mark.parametrize("B,H", [(1, 1), (2, 3), (8, 12)])
# the bf16 forward's N grid, then the f32 forward's own edges: it holds 128 query rows a
# block, 64 a consumer, and walks the key rows in stages of 64 through a ring of two parts
# (P V takes a stage's key rows 16 at a time): a second consumer with no rows (2), a stage
# cut mid-way (31, 33), one stage and then a second ring slot first used by one key row
# (64, 65), one block and then a block of one row (127, 129), a second block (255, 257)
@pytest.mark.parametrize("N", [1, 8, 32, 100, 112, 128, 192, 224, 256, 384, 1568,
                               2, 31, 33, 64, 65, 127, 129, 255, 257])
def test_flash_lean_f32_matches_float64(cuda, B, H, N, strided):
    """The f32 forward kernel (split TF32 on the tensor cores) against the plain version in
    float64 on the same operands: max |kernel − plain| / max |plain| ≤ 1e-5; the f32
    kernel's launch counted, the bf16 one's not."""
    from tpuhar_torch.ops.flash_lean import flash_lean, flash_lean_f32, flash_lean_reference

    q, k, v = _attention_case(B, H, N, cuda, dtype=torch.float32, strided=strided)
    before = flash_lean.launches, flash_lean_f32.launches
    got = flash_lean(q, k, v)
    assert (flash_lean.launches, flash_lean_f32.launches) == (before[0], before[1] + 1)
    want = flash_lean_reference(q.double(), k.double(), v.double())
    assert got.dtype == torch.float32 and got.shape == (B, H, N, 64)
    assert got.transpose(1, 2).is_contiguous()  # the (B, N, H, 64) buffer
    rel = (got.double() - want).abs().max() / want.abs().max()
    assert rel.item() <= F32_RTOL


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
# the bf16 backward's shapes (FLASH_BWD_SHAPES below): both f32 kernels hold 128 rows a
# block and walk the other side's rows in stages of 64 (dQ: 128 query rows, stages of key
# rows; dK/dV: 128 key rows, stages of query rows), which end at N = 64, 127, 128, 129 as
# the bf16 kernels' blocks and tiles do; their products' halves of 32 stage rows end at
# 31, 33, their second block at 255, 257; at N = 2 a block of two rows has a second
# consumer with none (at N = 1 dq and dk are 0: one key); at 65 the dQ kernel's second
# key-row part is first used by a stage of one key row, while its second consumer holds
# one query row
@pytest.mark.parametrize("B,H,N", [
    (16, 12, 1568), (8, 12, 1568), (1, 12, 1568), (2, 3, 1568), (2, 3, 32), (2, 3, 100), (2, 3, 224), (2, 3, 384),
    (2, 3, 64), (2, 3, 127), (2, 3, 128), (2, 3, 129), (2, 3, 200),
    (2, 3, 2), (2, 3, 31), (2, 3, 33), (2, 3, 255), (2, 3, 257), (2, 3, 65),
])
def test_flash_backward_f32_matches_float64(cuda, B, H, N, strided):
    """The f32 forward's log-sum-exp and the f32 dQ and dK/dV kernels against the plain
    backward in float64 on the same operands: lse within 1e-5 absolute, dq, dk and dv
    each within 1e-5 of its largest element, ``di`` as ``rowsum(O∘dO)``; the gradients f32
    views of (B, N, H, 64) buffers, and one launch of each f32 kernel."""
    from tpuhar_torch.ops.flash_lean import (
        flash_lean_backward,
        flash_lean_backward_reference,
        flash_lean_bwd_dkv,
        flash_lean_bwd_dkv_f32,
        flash_lean_bwd_dq,
        flash_lean_bwd_dq_f32,
        flash_lean_with_stats,
    )

    q, k, v = _attention_case(B, H, N, cuda, dtype=torch.float32, strided=strided)
    gen = torch.Generator(device=cuda).manual_seed(5)
    dout = torch.randn((B, N, H, 64), generator=gen, device=cuda)
    dout = dout.transpose(1, 2) if strided else dout.transpose(1, 2).contiguous()
    out, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.125)
    assert out_f32 is out
    want_lse = torch.logsumexp((q.double() @ k.double().mT) * 0.125, dim=-1)
    assert (lse.double() - want_lse).abs().max().item() <= 1e-5
    counts = lambda: (flash_lean_bwd_dkv.launches, flash_lean_bwd_dq.launches,  # noqa: E731
                      flash_lean_bwd_dkv_f32.launches, flash_lean_bwd_dq_f32.launches)
    before = counts()
    got = flash_lean_backward(q, k, v, out_f32, dout, lse, 0.125)
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    _, di = flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, 0.125)
    torch.testing.assert_close(di.double(), (out.double() * dout.double()).sum(dim=-1), rtol=1e-5, atol=1e-5)
    want = flash_lean_backward_reference(q.double(), k.double(), v.double(), dout.double(), 0.125)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (B, H, N, 64) and g.dtype == torch.float32, name
        assert g.transpose(1, 2).is_contiguous(), name
        rel = (g.double() - w).abs().max() / w.abs().max()
        assert rel.item() <= F32_RTOL, (name, rel.item())


@pytest.mark.parametrize("N", [129, 1568])
def test_flash_f32_forward_is_deterministic(cuda, N):
    """The f32 forward kernel, without and with its log-sum-exp: bit for bit equal across
    two calls (each block owns its query rows), and the same output either way."""
    from tpuhar_torch.ops.flash_lean import flash_lean, flash_lean_with_stats

    q, k, v = _attention_case(2, 3, N, cuda, dtype=torch.float32, strided=True)
    first, again = flash_lean(q, k, v), flash_lean(q, k, v)
    assert torch.equal(first, again)
    (out, lse, _), (out2, lse2, _) = (flash_lean_with_stats(q, k, v, 0.125) for _ in range(2))
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(out, first)


def test_f32_flash_kernel_attributes(cuda):
    """``_ext.kernel_attributes`` reads each f32 flash kernel's compiled attributes: 168
    registers a thread (384 threads, one block an SM; setmaxnreg moves them), the
    dynamic shared-memory limit its entry point set, and a name no table holds refused."""
    from tpuhar_torch import _ext
    from tpuhar_torch.ops.flash_lean import flash_lean, flash_lean_backward, flash_lean_with_stats

    q, k, v = _attention_case(1, 2, 200, cuda, dtype=torch.float32)
    flash_lean(q, k, v)  # each entry point sets its kernels' shared-memory limit at first use
    _, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.125)
    flash_lean_backward(q, k, v, out_f32, torch.ones_like(q), lse, 0.125)
    for name in _ext.ATTRIBUTE_KERNELS:
        attrs = _ext.kernel_attributes(name)
        assert set(attrs) == set(_ext.ATTRIBUTES), name
        assert attrs["registers"] == 168, (name, attrs)
        assert 190 * 1024 < attrs["max_dynamic_shared_bytes"] <= 227 * 1024, (name, attrs)
        assert attrs["local_bytes"] >= 0, (name, attrs)
    with pytest.raises(ValueError, match="not one of"):
        _ext.kernel_attributes("flash_attn")


def test_flash_f32_backward_is_deterministic(cuda):
    """The f32 dQ and dK/dV kernels: bit for bit equal across two calls (no atomics)."""
    from tpuhar_torch.ops.flash_lean import flash_lean_bwd_dkv, flash_lean_bwd_dq, flash_lean_with_stats

    q, k, v = _attention_case(2, 3, 1568, cuda, dtype=torch.float32, strided=True)
    dout = torch.randn((2, 1568, 3, 64), device=cuda).transpose(1, 2)
    _, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.125)
    first, again = (flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, 0.125) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    di = first[1]
    first, again = (flash_lean_bwd_dkv(q, k, v, dout, lse, di, 0.125) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_function_f32_gradients_through_attention(cuda):
    """``FlashSelfAttention`` in f32 with grad enabled: one launch of each f32 kernel and
    none of the bf16 ones, and the output and input gradient within 1e-5 of the plain f32
    attention's (TF32 off) on the same parameters."""
    from tpuhar_torch.models.layers import MultiHeadDotProductAttention
    from tpuhar_torch.ops.attention import FlashSelfAttention
    from tpuhar_torch.ops.flash_lean import (
        flash_lean,
        flash_lean_bwd_dkv,
        flash_lean_bwd_dkv_f32,
        flash_lean_bwd_dq,
        flash_lean_bwd_dq_f32,
        flash_lean_f32,
    )

    torch.manual_seed(0)
    flash = FlashSelfAttention(192, 3).to(cuda)
    plain = MultiHeadDotProductAttention(192, 3).to(cuda)
    plain.load_state_dict(flash.state_dict())
    x = torch.randn((2, 100, 192), device=cuda)
    counters = (flash_lean, flash_lean_bwd_dkv, flash_lean_bwd_dq, flash_lean_f32, flash_lean_bwd_dkv_f32,
                flash_lean_bwd_dq_f32)
    before = [c.launches for c in counters]
    outs, grads = [], []
    for module, args in ((flash, ()), (plain, (None,))):
        xi = x.clone().requires_grad_(True)
        out = module(xi) if not args else module(xi, xi)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append(xi.grad)
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 0, 0, 1, 1, 1]
    for got, want in zip((outs[0], grads[0]), (outs[1], grads[1])):
        assert ((got - want).abs().max() / want.abs().max()).item() <= F32_RTOL


def test_vit_slice_on_card_matches_cpu_f32(cuda):
    """The ViT forward cut to test size (``videomae_tiny`` on 4 frames of 64², 32
    tokens): bf16 on the card vs f32 on the CPU, same parameters; one flash launch
    per block."""
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.entry import build_forward, vit_config
    from tpuhar_torch.ops.flash_lean import flash_lean

    def config(dtype):
        cfg = vit_config(dtype)
        cfg.model.video_backbone = "videomae_tiny"
        cfg.data.video_resize, cfg.data.video_frames_per_window = (64, 64), 4
        return cfg

    params = init_params(config("float32"), torch.Generator().manual_seed(0))
    fn, _ = build_forward(config("bfloat16"), 2, device=cuda, params=params)
    ref_fn, _ = build_forward(config("float32"), 2, device="cpu", params=params)
    rng = np.random.default_rng(0)
    imu = torch.from_numpy(rng.normal(0, 8000, (2, 250, 6)).astype(np.float32))
    video = torch.from_numpy(rng.integers(0, 256, (2, 4, 64, 64, 3), dtype=np.uint8))
    before = flash_lean.launches
    got = fn(imu.to(cuda), video.to(cuda))
    assert flash_lean.launches == before + 4
    want = ref_fn(imu, video)
    for key in ("logits", "embeddings"):
        cos = torch.nn.functional.cosine_similarity(got[key].cpu().flatten(), want[key].flatten(), dim=0)
        assert cos.item() >= 0.99, key


# the backward's shapes: videomae_base at the pretraining batch (16), at 8, at 1 and on 3
# heads (a last block of 32 rows: its second consumer warpgroup has none, and a last
# tile of 32 rows), the ragged tiny shapes of the forward's cases (N below one 64-row
# tile, ragged, whole tiles), and the boundaries of the 128-row blocks and 64-row tiles of
# both backward kernels (dK/dV: key blocks, query tiles; dQ: query blocks, key tiles):
# N = 64, 127, 128, 129 (a second block of one row, a last tile of one valid row) and 200
FLASH_BWD_SHAPES = [
    (16, 12, 1568), (8, 12, 1568), (1, 12, 1568), (2, 3, 1568), (2, 3, 32), (2, 3, 100), (2, 3, 224), (2, 3, 384),
    (2, 3, 64), (2, 3, 127), (2, 3, 128), (2, 3, 129), (2, 3, 200),
]


@pytest.mark.parametrize("B,H,N", [(8, 12, 1568), (2, 3, 100), (1, 1, 1)])
def test_flash_lse_matches_logsumexp(cuda, B, H, N):
    """The forward's optional outputs: the log-sum-exp against ``torch.logsumexp`` of the
    f32 scaled scores (1e-3 absolute: the kernel's exponentials are ``ex2.approx``), the
    f32 output rounding to the bf16 one exactly, and the output bit for bit the one
    ``flash_lean`` gives with null pointers."""
    from tpuhar_torch.ops.flash_lean import flash_lean, flash_lean_with_stats

    q, k, v = _attention_case(B, H, N, cuda, strided=True)
    out, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.125)
    want = torch.logsumexp((q.float() @ k.float().mT) * 0.125, dim=-1)
    assert lse.shape == (B, H, N) and lse.dtype == torch.float32 and lse.is_contiguous()
    assert (lse - want).abs().max().item() <= 1e-3
    assert out_f32.dtype == torch.float32 and out_f32.transpose(1, 2).is_contiguous()
    assert torch.equal(out_f32.to(torch.bfloat16), out)
    assert torch.equal(out, flash_lean(q, k, v))


@pytest.mark.parametrize("B,H,N", FLASH_BWD_SHAPES)
def test_flash_backward_matches_plain(cuda, B, H, N):
    """dq, dk and dv of the two kernels against autograd through the plain version on the
    card: max |kernel − plain| / max |plain| ≤ 2e-2 each (bf16 out; P and dS round to
    bf16 before their products, as on the TPU)."""
    from tpuhar_torch.ops.flash_lean import (
        flash_lean_backward,
        flash_lean_backward_reference,
        flash_lean_bwd_dkv,
        flash_lean_bwd_dq,
        flash_lean_with_stats,
    )

    q, k, v = _attention_case(B, H, N, cuda, strided=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    dout = torch.randn((B, N, H, 64), generator=gen, device=cuda).to(torch.bfloat16).transpose(1, 2)
    out, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.125)
    before = flash_lean_bwd_dkv.launches, flash_lean_bwd_dq.launches
    got = flash_lean_backward(q, k, v, out_f32, dout, lse, 0.125)
    assert (flash_lean_bwd_dkv.launches, flash_lean_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    _, di = flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, 0.125)  # the dQ kernel's rowsum(O∘dO)
    torch.testing.assert_close(di, (out_f32 * dout.float()).sum(dim=-1), rtol=1e-5, atol=1e-4)
    want = flash_lean_backward_reference(q, k, v, dout, 0.125)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (B, H, N, 64) and g.dtype == torch.bfloat16, name
        assert g.transpose(1, 2).is_contiguous(), name  # a (B, N, H, 64) buffer
        rel = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert rel.item() <= 2e-2, (name, rel.item())


@pytest.mark.parametrize("N", [129, 1568])
def test_flash_dkv_is_deterministic(cuda, N):
    """dk and dv of the dK/dV kernel, and dq and ``di`` of the dQ kernel, bit for bit equal
    across two calls (no atomics, a fixed order of sums), and the same from contiguous
    ``(B, H, N, 64)`` operands as from the strided views of ``(B, N, H, 64)`` buffers (the
    other order of a tensor map's dimensions)."""
    from tpuhar_torch.ops.flash_lean import flash_lean_bwd_dkv, flash_lean_bwd_dq, flash_lean_with_stats

    q, k, v = _attention_case(2, 3, N, cuda, strided=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    dout = torch.randn((2, N, 3, 64), generator=gen, device=cuda).to(torch.bfloat16).transpose(1, 2)
    _, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.125)
    packed_ops = [t.contiguous() for t in (q, k, v, dout)]
    assert not q.is_contiguous() and packed_ops[0].stride()[1] > packed_ops[0].stride()[2]
    dq_first = flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, 0.125)
    dq_again = flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, 0.125)
    dq_packed = flash_lean_bwd_dq(*packed_ops[:3], out_f32, packed_ops[3], lse, 0.125)
    di = dq_first[1]
    first = flash_lean_bwd_dkv(q, k, v, dout, lse, di, 0.125)
    again = flash_lean_bwd_dkv(q, k, v, dout, lse, di, 0.125)
    packed = flash_lean_bwd_dkv(*packed_ops, lse, di, 0.125)
    for name, a, b, c in zip(("dq", "di", "dk", "dv"), (*dq_first, *first), (*dq_again, *again), (*dq_packed, *packed)):
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name


@pytest.mark.parametrize("N", [100, 129])
def test_flash_dq_masks_key_columns_past_n(cuda, N):
    """Every score of every row near -128 (q about 4, k about -4 in each column): where
    the dQ kernel's last 64-row key tile runs past N, its zero-filled key rows have S = 0
    and exp(S - lse) overflows f32, so P must be 0 there, or dS K gives inf x 0 = NaN.
    dq, dk and dv finite and within 2e-2 of the plain backward, as at random operands
    (on the CPU, the kernels' roundings of dS to bf16 on these operands leave dq 4.4e-3
    and 6.6e-3 off the plain backward: K's common -4 cancels from dS K only in exact
    arithmetic)."""
    from tpuhar_torch.ops.flash_lean import flash_lean_backward, flash_lean_backward_reference, flash_lean_with_stats

    gen = torch.Generator(device=cuda).manual_seed(3)
    shape = (2, N, 3, 64)
    q = (4 + torch.randn(shape, generator=gen, device=cuda)).to(torch.bfloat16).transpose(1, 2)
    k = (-4 + torch.randn(shape, generator=gen, device=cuda)).to(torch.bfloat16).transpose(1, 2)
    v, dout = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    _, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.125)
    assert lse.max().item() < -89  # exp(-lse) overflows f32
    got = flash_lean_backward(q, k, v, out_f32, dout, lse, 0.125)
    want = flash_lean_backward_reference(q, k, v, dout, 0.125)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        rel = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert rel.item() <= 2e-2, (name, rel.item())


def test_flash_function_gradients_through_attention(cuda):
    """``FlashSelfAttention`` with grad enabled: one forward launch with the LSE and one
    launch of each backward kernel, and its input gradient close to the plain
    attention's on the same parameters."""
    from tpuhar_torch.models.layers import MultiHeadDotProductAttention
    from tpuhar_torch.ops.attention import FlashSelfAttention
    from tpuhar_torch.ops.flash_lean import flash_lean, flash_lean_bwd_dkv, flash_lean_bwd_dq

    torch.manual_seed(0)
    flash = FlashSelfAttention(192, 3).to(cuda, torch.bfloat16)
    plain = MultiHeadDotProductAttention(192, 3).to(cuda, torch.bfloat16)
    plain.load_state_dict(flash.state_dict())
    x = torch.randn((2, 100, 192), device=cuda).to(torch.bfloat16)
    grads = []
    before = flash_lean.launches, flash_lean_bwd_dkv.launches, flash_lean_bwd_dq.launches
    for module, args in ((flash, ()), (plain, (None,))):
        xi = x.clone().requires_grad_(True)
        out = module(xi) if not args else module(xi, xi)
        out.float().square().sum().backward()
        grads.append(xi.grad.float())
    assert (flash_lean.launches, flash_lean_bwd_dkv.launches, flash_lean_bwd_dq.launches) == tuple(
        n + 1 for n in before
    )
    cos = torch.nn.functional.cosine_similarity(grads[0].flatten(), grads[1].flatten(), dim=0)
    assert cos.item() >= 0.99


def test_flash_backward_refuses(cuda):
    from tpuhar_torch.ops.flash_lean import flash_lean_bwd_dkv, flash_lean_bwd_dq, flash_lean_with_stats

    q, k, v = _attention_case(1, 2, 64, cuda)
    out, lse, out_f32 = flash_lean_with_stats(q, k, v, 0.125)
    di = torch.zeros_like(lse)
    # (dO, lse) into each kernel: dK/dV also reads di, dQ the forward's f32 output
    calls = (lambda dout, lse: flash_lean_bwd_dkv(q, k, v, dout, lse, di, 0.125),
             lambda dout, lse: flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, 0.125))
    for call in calls:
        with pytest.raises(ValueError, match="bfloat16"):
            call(out.float(), lse)
        with pytest.raises(ValueError, match="float32"):
            call(out, lse.double())
        with pytest.raises(ValueError, match="contiguous"):
            call(out, lse.transpose(1, 2).contiguous().transpose(1, 2))
        with pytest.raises(ValueError, match="broadcast"):
            call(out[:, :1].expand(1, 2, 64, 64), lse)
    with pytest.raises(ValueError, match="positive"):
        flash_lean_bwd_dkv(q, k, v, out, lse, di, 0.0)
    with pytest.raises(ValueError, match="positive"):
        flash_lean_bwd_dq(q, k, v, out_f32, out, lse, 0.0)
    with pytest.raises(ValueError, match="out_f32"):  # the bf16 output in place of the f32 one
        flash_lean_bwd_dq(q, k, v, out, out, lse, 0.125)
    with pytest.raises(ValueError, match="di"):
        flash_lean_bwd_dkv(q, k, v, out, lse, di[:, :1], 0.125)


# the serving engine on the card: one program per serving path at a small depth (4
# frames of 64², videomae_tiny) and the kernels' full widths, batch sizes 2 and 4
ENGINE_SIZE, ENGINE_FRAMES = 64, 4


def _engine_case(path, device):
    """``(config, engine kwargs, eager forward at the same parameters, launches of each
    serving kernel in one forward)`` for one serving path."""
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.entry import build_forward, build_int8_forward, flagship_config, vit_config

    vit = "vit" in path
    f32 = path in ("f32", "vit_f32")
    cfg = vit_config("float32" if f32 else "bfloat16") if vit else flagship_config("float32" if f32 else "bfloat16")
    if vit:
        cfg.model.video_backbone = "videomae_tiny"
    cfg.data.video_resize, cfg.data.video_frames_per_window = (ENGINE_SIZE, ENGINE_SIZE), ENGINE_FRAMES
    params = init_params(cfg, torch.Generator().manual_seed(0))
    launches = dict.fromkeys(("fused_window", "conv3x3_bn_act", "conv3x3_bn_act_f32", "stem_gemm_u8", "conv3x3_i8",
                              "int8_gemm", "flash_lean", "flash_lean_f32"), 0)
    launches["fused_window"] = 1
    if path in ("int8_vit", "int8_resnet18", "int8_resnet18_resident"):  # the ViT with vit_config()'s tanh GELU
        cfg.model.video_backbone = "videomae_tiny" if path == "int8_vit" else "resnet18"
        params = init_params(cfg, torch.Generator().manual_seed(0))
        clips = np.random.default_rng(0).integers(0, 256, (2, ENGINE_FRAMES, ENGINE_SIZE, ENGINE_SIZE, 3), dtype=np.uint8)
        resident = path.endswith("resident")
        kw = dict(quantize_calib_clips=clips, quantize_resident=resident)
        fn, _ = build_int8_forward(cfg, 4, device=device, params=params, calib_clips=clips, resident=resident)
        launches.update(dict(stem_gemm_u8=1, int8_gemm=16) if path == "int8_vit" else dict(int8_gemm=4, conv3x3_i8=16))
    elif path.startswith("int8"):
        clips = np.random.default_rng(0).integers(0, 256, (2, ENGINE_FRAMES, ENGINE_SIZE, ENGINE_SIZE, 3), dtype=np.uint8)
        resident = path == "int8_resident"
        kw = dict(quantize_calib_clips=clips, quantize_resident=resident, verify_byte_map=True)
        fn, _ = build_int8_forward(cfg, 4, device=device, params=params, calib_clips=clips, resident=resident)
        launches.update(stem_gemm_u8=1, conv3x3_i8=5)
    else:
        # unfolded: the clip normalized on the device with statistics made at build time
        fold = not path.endswith("unfolded")
        kw = dict(fast_attention=True, fold_normalize=fold) if vit else dict(fold_normalize=fold)
        fn, _ = build_forward(cfg, 4, device=device, params=params, fold_normalize=fold)
        conv = "conv3x3_bn_act_f32" if path == "f32" else "conv3x3_bn_act"  # the f32 flagship: the f32 form
        launches.update({"flash_lean_f32" if f32 else "flash_lean": 4} if vit else {conv: 4})
    return cfg, params, kw, fn, launches


def _engine_request(n, seed):
    rng = np.random.default_rng(seed)
    imu = rng.normal(0, 8000, (n, 250, 6)).astype(np.float32)
    return imu, rng.integers(0, 256, (n, ENGINE_FRAMES, ENGINE_SIZE, ENGINE_SIZE, 3), dtype=np.uint8)


def _assert_bitwise(got, want, what):
    """Every output of ``want`` equal in ``got``, bit for bit, or the output named
    with its largest difference."""
    for key, value in want.items():
        value = np.asarray(value)
        if not np.array_equal(got[key], value):
            diff = np.abs(got[key].astype(np.float64) - value.astype(np.float64)).max()
            raise AssertionError(f"{what}: {key} differs from the eager call by up to {diff:.3e}")


@pytest.mark.parametrize(
    "path",
    ["bf16", "bf16_unfolded", "int8_resident", "int8_baseline", "vit", "vit_unfolded", "int8_vit", "int8_resnet18",
     "int8_resnet18_resident", "f32", "vit_f32"],
)
def test_engine_replays_the_eager_program(cuda, path):
    """One CUDA graph per registered size, each holding the eager forward's kernel
    launches; a replay (``predict``, padded 3 → 4 and 2 → 2) equals the eager program on
    the same padded inputs bit for bit, and ``predict_stream`` equals ``predict``."""
    from tpuhar_torch.serving import InferenceEngine, kernel_launches

    cfg, params, kw, eager, launches = _engine_case(path, cuda)
    engine = InferenceEngine(cfg, params, batch_sizes=[4, 2], device=cuda, **kw)
    engine.warmup()
    assert sorted(engine._graphs) == [2, 4]
    assert engine.graph_launches == {2: launches, 4: launches}
    requests = [_engine_request(n, 10 + n) for n in (3, 2, 4)]
    for imu, video in requests:
        b = engine._padded_size(len(imu))
        before = kernel_launches()
        got = engine.predict(imu, video)
        assert kernel_launches() == before  # a replay calls no wrapper
        args = [torch.from_numpy(a).to(cuda) for a in engine._pad_to(imu, video, b)]
        want = {k: v[: len(imu)].cpu().numpy() for k, v in eager(*args).items()}
        _assert_bitwise(got, want, f"{path} batch {b}")
        np.testing.assert_array_equal(got["preds"], want["logits"].argmax(-1))
        assert got["preds"].dtype == np.int32
    batches = [requests[0], {"imu": requests[1][0], "video": requests[1][1]}, requests[2], requests[0]]
    for depth in (1, 2, 3):
        outs = list(engine.predict_stream(iter(batches), depth=depth))
        assert len(outs) == len(batches)
        for out, batch in zip(outs, batches):
            imu, video = (batch["imu"], batch["video"]) if isinstance(batch, dict) else batch
            _assert_bitwise(out, engine.predict(imu, video), f"{path} stream depth {depth}")


@contextlib.contextmanager
def _plain_int8_kernels():
    """The int8 towers' kernel wrappers replaced by their plain versions inside."""
    from tpuhar_torch.ops import quant, quant_vit

    swaps = [(quant, "int8_gemm", int8_gemm_reference), (quant, "conv3x3_i8", conv3x3_i8_reference),
             (quant_vit, "int8_gemm", int8_gemm_reference), (quant_vit, "stem_gemm_u8", stem_gemm_u8_reference)]
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    try:
        for module, name, plain in swaps:
            setattr(module, name, plain)
        yield
    finally:
        for module, name, original in saved:
            setattr(module, name, original)


@pytest.mark.parametrize("path", ["int8_vit", "int8_resnet18", "int8_resnet18_resident"])
def test_int8_towers_equal_their_plain_kernel_programs(cuda, path):
    """Each int8 tower's program on the card equals, bit for bit, the same program with
    its kernels' plain versions in their place: every other op is the same on the same
    device."""
    cfg, params, kw, fn, launches = _engine_case(path, cuda)
    imu, video = (torch.from_numpy(a).to(cuda) for a in _engine_request(4, 90))
    before = int8_gemm.launches
    got = fn(imu, video)
    assert int8_gemm.launches == before + launches["int8_gemm"]
    with _plain_int8_kernels():
        want = fn(imu, video)
    assert int8_gemm.launches == before + launches["int8_gemm"]
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_imu_only_engine_with_scorers_replays_eagerly(cuda):
    """IMU-only serving (the featurizer, the IMU encoder and head) with a calibration
    temperature and the Mahalanobis, RMD and KNN scorers captured in the graph: a
    replay equals the same program called eagerly, bit for bit."""
    from tpuhar_torch import ood
    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.entry import flagship_config
    from tpuhar_torch.models.crossmodal import IMUClassifier
    from tpuhar_torch.serving import InferenceEngine

    cfg = flagship_config()
    params = init_params(cfg, torch.Generator().manual_seed(0), IMUClassifier)
    rng = np.random.default_rng(0)
    emb, labels = rng.normal(size=(300, cfg.model.imu_d_model)).astype(np.float32), rng.integers(0, 32, 300)
    engine = InferenceEngine(
        cfg, params, imu_only=True, batch_sizes=[8], temperature=2.0, device=cuda,
        mahalanobis=ood.MahalanobisScorer.fit(emb, labels, 32),
        extra_scorers={"rmd": ood.RelativeMahalanobisScorer.fit(emb, labels, 32), "knn": ood.KNNScorer.fit(emb, k=10)},
    )
    engine.warmup()
    assert engine.graph_launches[8]["fused_window"] == 1
    imu = _engine_request(6, 3)[0]
    got = engine.predict(imu)
    want = engine._forward(*(torch.from_numpy(a).to(cuda) for a in engine._pad_to(imu, None, 8)))
    _assert_bitwise(got, {k: v[:6].cpu().numpy() for k, v in want.items()}, "imu_only")
    assert {"mahalanobis", "rmd", "knn"} <= set(got)
    _assert_bitwise(next(iter(engine.predict_stream([imu]))), got, "imu_only stream")


def test_engine_capture_error_propagates(cuda):
    """A program that waits for the device cannot be captured: the error leaves
    ``warmup`` (and ``predict``), and no graph is kept; nothing runs it eagerly
    instead."""
    from tpuhar_torch.serving import InferenceEngine

    cfg, params, kw, _, _ = _engine_case("bf16", cuda)
    engine = InferenceEngine(cfg, params, batch_sizes=[2], device=cuda, **kw)
    program = engine._program

    def waits(imu_raw, video_u8):
        logits, emb = program(imu_raw, video_u8)
        if logits.sum().item() != logits.sum().item():  # a device sync: illegal under capture
            raise AssertionError("NaN logits")
        return logits, emb

    engine._program = waits
    with pytest.raises(RuntimeError):
        engine.warmup()
    assert not engine._graphs
    with pytest.raises(RuntimeError):
        engine.predict(*_engine_request(2, 1))
    torch.cuda.synchronize()


# the classifiers' train steps on the card: videomae_tiny at 4 frames of 64² (32 tokens),
# bf16 with the flash kernels, batch 4, a LayerNorm head and dropout 0 (the same forward
# in both runs); held against the plain path on the card (f32, attention without flash,
# TF32 off): the loss within 2e-2 and the whole gradient, as one vector, at cosine 0.95
# or more (bf16 against f32 over every leaf)
CLASSIFY_LOSS_RTOL, CLASSIFY_COSINE_MIN = 2e-2, 0.95


@pytest.mark.parametrize("kind", ["video", "fusion"])
def test_classifier_train_step_launches_the_flash_kernels(cuda, kind):
    """One ``train_step`` of the video-only or the fusion classifier launches, per ViT
    block, one flash forward with the LSE and one of each backward kernel; its loss and
    gradient agree with the plain path's on the same parameters and batch."""
    import copy

    from tpuhar_torch.bridge import init_params
    from tpuhar_torch.entry import build_fusion_task, build_video_task, pretrain_config
    from tpuhar_torch.models.crossmodal import FusionClassifier, VideoClassifier
    from tpuhar_torch.models.video import VIT_CONFIGS
    from tpuhar_torch.ops.flash_lean import flash_lean, flash_lean_bwd_dkv, flash_lean_bwd_dq

    cfg = pretrain_config()
    m = cfg.model
    m.video_backbone, m.head_norm = "videomae_tiny", "layer"
    m.imu_dropout = m.classifier_dropout = 0.0
    cfg.data.video_resize, cfg.data.video_frames_per_window = (ENGINE_SIZE, ENGINE_SIZE), ENGINE_FRAMES
    model_cls, build = (VideoClassifier, build_video_task) if kind == "video" else (FusionClassifier, build_fusion_task)
    params = init_params(cfg, torch.Generator().manual_seed(0), model_cls)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {
        "imu": torch.randn((4, 6, 250), generator=gen, device=cuda),
        "video": torch.randint(0, 256, (4, ENGINE_FRAMES, ENGINE_SIZE, ENGINE_SIZE, 3), generator=gen,
                               device=cuda, dtype=torch.uint8),
        "label": torch.randint(0, m.num_classes, (4,), generator=gen, device=cuda),
    }
    depth = VIT_CONFIGS[m.video_backbone][0]
    results = {}
    for path, flash in (("flash", True), ("plain", False)):
        c = copy.deepcopy(cfg)
        c.model.use_flash_attention = flash
        c.model.compute_dtype = "bfloat16" if flash else "float32"
        task = build(c, device=cuda, params=params, steps_per_epoch=1)
        counters = (flash_lean, flash_lean_bwd_dkv, flash_lean_bwd_dq)
        before = [f.launches for f in counters]
        _, out = task.train_step(task.state, batch, None)
        torch.cuda.synchronize()
        launched = [f.launches - b for f, b in zip(counters, before)]
        assert launched == ([depth] * 3 if flash else [0, 0, 0]), (path, launched)
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten()
                           for p in task.model.parameters()])  # the step's gradient
        results[path] = (out["loss"].item(), grads)
    (loss, grads), (loss_ref, grads_ref) = results["flash"], results["plain"]
    assert abs(loss - loss_ref) <= CLASSIFY_LOSS_RTOL * abs(loss_ref), (loss, loss_ref)
    cos = torch.nn.functional.cosine_similarity(grads.double(), grads_ref.double(), dim=0).item()
    assert cos >= CLASSIFY_COSINE_MIN, cos
