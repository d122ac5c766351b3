"""The f32 fused conv's split-TF32 arithmetic on the CPU: ``split_tf32``, the weights'
repack into the kernel's K-major halves (``pack_conv3x3_f32``), and the kernel's three
products emulated in float64 against the float64 conv.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``); its plain
version is the f32 ``F.conv2d`` that ``tests/test_torch_conv3x3.py`` holds against the
JAX package's Pallas kernel.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuhar_torch.ops.conv3x3 import (
    CONV_F32_K_CHUNK,
    CONV_F32_N_TILE,
    conv3x3_bn_act_f32,
    conv3x3_bn_act_reference,
    pack_conv3x3_f32,
    split_tf32,
)

torch.set_num_threads(2)

F32_MAX = float(np.finfo(np.float32).max)
# half of TF32's least subnormal, 2^-136: below about 2^-115, lo falls among TF32's
# subnormals and this step, not 2^-22 |v|, bounds what the split leaves over
SUBNORMAL_SLACK = 2.0**-137


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _values(seed: int = 0) -> torch.Tensor:
    """Finite f32 values of both signs over every binade, subnormals, zeros and the
    largest finite value."""
    rng = np.random.default_rng(seed)
    normal = rng.uniform(1, 2, 4000) * 2.0 ** rng.integers(-126, 128, 4000)
    sub = rng.integers(1, 2**23, 500) * 2.0**-149  # every subnormal is k · 2^-149
    v = np.concatenate([normal, sub, [0.0, F32_MAX, 2.0**-126, 2.0**-149, 1.0, 3.0]])
    v = v * np.where(rng.random(v.size) < 0.5, -1.0, 1.0)
    return torch.from_numpy(np.concatenate([v, [-0.0, -F32_MAX]]).astype(np.float32))


def test_split_tf32_drops_the_low_13_bits():
    v = _values()
    hi, lo = split_tf32(v)
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == lo.shape == v.shape
    assert not (_bits(hi) & 0x1FFF).any()
    assert not (_bits(lo) & 0x1FFF).any()


def test_split_tf32_rounds_to_nearest_ties_away_from_zero():
    """``hi`` against round-half-away in float64 on TF32's grid of ``v``'s binade (11
    significant bits), on random values and on exact ties of both signs."""
    rng = np.random.default_rng(1)
    e = rng.integers(-100, 100, 2000).astype(np.float64)
    ties = (1024 + rng.integers(0, 1024, 2000) + 0.5) * 2.0 ** (e - 10)  # halfway between two TF32 values
    v = np.concatenate([ties, rng.uniform(1, 2, 2000) * 2.0**e])
    v = (v * np.where(rng.random(v.size) < 0.5, -1.0, 1.0)).astype(np.float32)
    hi, _ = split_tf32(torch.from_numpy(v))
    a = np.abs(v.astype(np.float64))
    step = 2.0 ** (np.floor(np.log2(a)) - 10)
    want = np.sign(v) * np.floor(a / step + 0.5) * step
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), want)
    assert (np.abs(hi.numpy()[:2000]) > np.abs(v[:2000])).all()  # every tie went away from zero


def test_split_tf32_leaves_at_most_2_pow_minus_22():
    v = _values(2)
    hi, lo = split_tf32(v)
    v64, rest = v.double(), v.double() - hi.double() - lo.double()
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()  # the largest finite value too
    assert (rest.abs() <= torch.clamp(2.0**-22 * v64.abs(), min=SUBNORMAL_SLACK)).all()
    normal = v64.abs() >= 2.0**-100
    assert (rest[normal].abs() <= 2.0**-22 * v64[normal].abs()).all()
    assert (hi.double() + lo.double() == v64)[v64 == 0].all()


def test_split_tf32_inf_nan_and_zeros():
    inf = float("inf")
    v = torch.tensor([inf, -inf, float("nan"), 0.0, -0.0, F32_MAX, -F32_MAX])
    bits = v.numpy().view(np.uint32).copy()
    bits[2] = 0x7F800001  # a NaN whose payload is all in the 13 bits TF32 drops
    v = torch.from_numpy(bits.view(np.float32))
    hi, lo = split_tf32(v)
    assert hi[0].item() == inf and hi[1].item() == -inf
    assert torch.isnan(hi[2]) and torch.isnan(v[2])
    assert (lo[:3] == 0).all()
    np.testing.assert_array_equal(_bits(hi[3:5]), [0, 0x80000000])  # signed zeros stay
    assert (lo[3:5] == 0).all()
    # the largest finite value would round to inf: it is cut instead, and lo holds the rest
    assert torch.isfinite(hi[5:]).all() and (hi[5:].abs() < F32_MAX).all()
    rest = v[5:].double() - hi[5:].double() - lo[5:].double()
    assert (rest.abs() <= 2.0**-22 * v[5:].double().abs()).all()


@pytest.mark.parametrize("c,c_out", [(48, 40), (256, 256), (33, 130)])
def test_pack_conv3x3_f32_entry_by_entry(c, c_out):
    gen = torch.Generator().manual_seed(c)
    kernel = torch.randn((3, 3, c, c_out), generator=gen)
    w_hi, w_lo = pack_conv3x3_f32(kernel)
    c_pad = -(-c // CONV_F32_K_CHUNK) * CONV_F32_K_CHUNK
    c_out_pad = -(-c_out // CONV_F32_N_TILE) * CONV_F32_N_TILE
    assert w_hi.shape == w_lo.shape == (c_out_pad, 9 * c_pad)
    assert w_hi.is_contiguous() and w_lo.is_contiguous()
    assert c_pad % 32 == 0 and c_out_pad % 128 == 0
    hi, lo = split_tf32(kernel)
    for dy in range(3):
        for dx in range(3):
            tap = dy * 3 + dx
            block = slice(tap * c_pad, tap * c_pad + c)
            assert torch.equal(w_hi[:c_out, block], hi[dy, dx].T)
            assert torch.equal(w_lo[:c_out, block], lo[dy, dx].T)
            assert not w_hi[:, tap * c_pad + c:(tap + 1) * c_pad].any()  # channels past C
            assert not w_lo[:, tap * c_pad + c:(tap + 1) * c_pad].any()
    assert not w_hi[c_out:].any() and not w_lo[c_out:].any()  # output channels past C_out


def _rows(x: torch.Tensor, c_pad: int) -> torch.Tensor:
    """The kernel's A: each output pixel's nine tap-shifted rows of ``x`` (zeros off the
    plane and past C), side by side in the order ``(dy·3 + dx)·C_pad + c``."""
    n, s, _, c = x.shape
    xp = F.pad(x, (0, c_pad - c, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + s, dx:dx + s] for dy in range(3) for dx in range(3)], -1).reshape(n * s * s, -1)


@pytest.mark.parametrize("n,s,c", [(2, 14, 256), (2, 7, 512)])  # K = 2304 and 4608
def test_split_products_match_the_float64_conv(n, s, c):
    """The kernel's arithmetic, ``lo_a·hi_b + hi_a·lo_b + hi_a·hi_b``, with each product
    and sum exact in float64: what is left is the dropped ``lo_a·lo_b`` and what the
    splits leave over, within 1e-6 of the largest output (the kernel's f32 sums add f32
    rounding on top, held to 1e-5 on the card)."""
    gen = torch.Generator().manual_seed(s)
    x = torch.relu(torch.randn((n, s, s, c), generator=gen))
    kernel = torch.randn((3, 3, c, c), generator=gen) * (9 * c) ** -0.5
    w_hi, w_lo = (w.double() for w in pack_conv3x3_f32(kernel))
    a_hi, a_lo = (a.double() for a in split_tf32(_rows(x, w_hi.shape[1] // 9)))
    got = (a_lo @ w_hi.T + a_hi @ w_lo.T + a_hi @ w_hi.T)[:, :c].reshape(n, s, s, c)
    want = F.conv2d(x.double().permute(0, 3, 1, 2), kernel.double().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6
    # a single TF32 product (hi_a·hi_b) keeps about three decimal digits
    tf32 = (a_hi @ w_hi.T)[:, :c].reshape(n, s, s, c)
    assert ((tf32 - want).abs().max() / want.abs().max()).item() > 1e-5


def test_f32_wrapper_takes_the_plain_version_on_the_cpu():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 5, 48), generator=gen)
    kernel = torch.randn((3, 3, 48, 40), generator=gen)
    scale, bias, res = torch.rand(40, generator=gen), torch.randn(40, generator=gen), torch.randn((2, 5, 5, 40))
    before = conv3x3_bn_act_f32.launches
    got = conv3x3_bn_act_f32(x, kernel, scale, bias, residual=res, relu=False)
    assert conv3x3_bn_act_f32.launches == before
    assert torch.equal(got, conv3x3_bn_act_reference(x, kernel, scale, bias, res, False))


def test_engine_counts_the_f32_conv():
    """``InferenceEngine`` records each graph's launches of every serving kernel, the f32
    conv of an f32 ``tpu_cnn`` among them: every hand kernel but the flash backward's two
    (in bf16 and in f32)."""
    from tpuhar_torch import serving
    from tpuhar_torch.entry import launch_counters

    training_only = {"flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_dkv_f32", "flash_bwd_dq_f32"}
    assert serving.KERNEL_COUNTERS == {k: v for k, v in launch_counters().items() if k not in training_only}
    assert "conv3x3_bn_act_f32" in serving.kernel_launches()
