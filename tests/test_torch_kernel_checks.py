"""The operand checks of the bf16 and int8 convs (the int8 conv's padding too), the
uint8 stem and the int8 GEMM, the flash kernels
(forward and backward) and the fused window featurizer, as
pure functions of shapes, strides and addresses: what the Hopper kernels take and what
the wrappers refuse before any launch. No device is needed; the kernels themselves are held against their plain
versions on the card by ``tests/test_torch_kernels_cuda.py``."""
import pytest
import torch

from tpuhar_torch.ops.conv3x3 import (
    check_conv3x3_f32_shapes,
    check_conv3x3_i8_shapes,
    check_conv3x3_shapes,
    conv3x3_bn_act,
    conv3x3_i8_pad_lo,
)
from tpuhar_torch.ops.flash_lean import (
    HEAD_DIM,
    check_flash_grad_operands,
    check_flash_operand,
    check_flash_scale,
    flash_lean,
)
from tpuhar_torch.ops.fused_window import (
    MAX_LANE,
    SMEM_MAX,
    LaunchPlan,
    check_fused_window_operand,
    featurize_windows_auto,
    launch_plan,
    median_taps,
)
from tpuhar_torch.ops.stem import check_int8_gemm_shapes, check_stem_u8_shapes


@pytest.mark.parametrize(
    "x,kernel,residual",
    [
        ((4096, 14, 14, 256), (3, 3, 256, 256), (4096, 14, 14, 256)),  # s0 at batch 256
        ((4096, 7, 7, 512), (3, 3, 512, 512), None),  # s1 at batch 256
        ((128, 14, 14, 256), (3, 3, 256, 256), (128, 14, 14, 256)),  # batch 8
        ((3, 7, 7, 512), (3, 3, 512, 512), (3, 7, 7, 512)),  # M = 147, ragged
        ((2, 5, 5, 64), (3, 3, 64, 80), None),  # C_out a multiple of 8 only
        ((1, 1, 1, 64), (3, 3, 64, 8), (1, 1, 1, 8)),
    ],
)
def test_conv3x3_shapes_taken(x, kernel, residual):
    check_conv3x3_shapes(x, kernel, residual)


@pytest.mark.parametrize(
    "x,kernel,residual,match",
    [
        ((14, 14, 256), (3, 3, 256, 256), None, r"\(N, S, S, C\)"),
        ((2, 7, 6, 128), (3, 3, 128, 128), None, "square"),
        ((2, 7, 7, 128), (3, 3, 64, 128), None, "weights"),
        ((2, 7, 7, 128), (1, 1, 128, 128), None, "weights"),
        ((2, 7, 7, 128), (3, 3, 128), None, "weights"),
        ((2, 7, 7, 120), (3, 3, 120, 128), None, "multiple of 64"),  # C: half a 128-byte row
        ((2, 7, 7, 48), (3, 3, 48, 80), None, "multiple of 64"),
        ((2, 7, 7, 128), (3, 3, 128, 100), None, "of 8"),  # C_out: 16-byte stores
        ((2, 7, 7, 128), (3, 3, 128, 128), (2, 7, 7, 64), "residual"),
        ((2, 7, 7, 128), (3, 3, 128, 128), (1, 7, 7, 128), "residual"),
        ((2**31 // 49 + 1, 7, 7, 64), (3, 3, 64, 64), None, "2\\^31"),
    ],
)
def test_conv3x3_shapes_refused(x, kernel, residual, match):
    with pytest.raises(ValueError, match=match):
        check_conv3x3_shapes(x, kernel, residual)


@pytest.mark.parametrize(
    "x,kernel,residual",
    [
        ((8, 2, 2, 256), (3, 3, 256, 256), (8, 2, 2, 256)),  # the dry run's tower in f32
        ((16, 1, 1, 512), (3, 3, 512, 512), None),
        ((3, 7, 7, 48), (3, 3, 48, 40), None),  # any C and C_out
    ],
)
def test_conv3x3_f32_shapes_taken(x, kernel, residual):
    check_conv3x3_f32_shapes(x, kernel, residual)


@pytest.mark.parametrize(
    "x,kernel,residual,match",
    [
        ((2, 2, 256), (3, 3, 256, 256), None, r"\(N, S, S, C\)"),
        ((8, 2, 1, 256), (3, 3, 256, 256), None, r"\(N, S, S, C\)"),
        ((8, 2, 2, 256), (3, 3, 128, 256), None, "weights"),
        ((8, 2, 2, 256), (3, 3, 256, 256), (8, 2, 2, 128), "residual"),
        ((2**21, 32, 32, 8), (3, 3, 8, 8), None, "2\\^31"),
    ],
)
def test_conv3x3_f32_shapes_refused(x, kernel, residual, match):
    with pytest.raises(ValueError, match=match):
        check_conv3x3_f32_shapes(x, kernel, residual)


# (C, C_out, stride, residual, out) of the five int8 convs of the tower
_I8_CONVS = [(14, 256, 256, 1, True), (14, 256, 256, 1, False), (14, 256, 512, 2, False),
             (7, 512, 512, 1, False), (7, 512, 512, 1, True)]


@pytest.mark.parametrize("frames", [4096, 128], ids=["batch256", "batch8"])
@pytest.mark.parametrize("s,c,c_out,stride,residual", _I8_CONVS)
def test_conv3x3_i8_path_shapes_taken(frames, s, c, c_out, stride, residual):
    so = -(-s // stride)
    check_conv3x3_i8_shapes((frames, s, s, c), (c_out, 9 * c), stride, (frames, so, so, c_out) if residual else None)


@pytest.mark.parametrize(
    "x,w,stride,residual",
    [
        ((4, 9, 9, 32), (32, 9 * 32), 1, None),  # a quarter of a 128-byte row of channels
        ((2, 5, 5, 96), (160, 9 * 96), 2, (2, 3, 3, 160)),  # odd plane at stride 2
        ((3, 7, 7, 160), (288, 9 * 160), 1, (3, 7, 7, 288)),  # a partial row and a partial 256-wide box
        ((3, 14, 14, 256), (512, 9 * 256), 2, None),  # ragged M at stride 2
        ((1, 1, 1, 32), (160, 9 * 32), 1, None),  # C_out = 160
    ],
)
def test_conv3x3_i8_shapes_taken(x, w, stride, residual):
    check_conv3x3_i8_shapes(x, w, stride, residual)


@pytest.mark.parametrize(
    "x,w,stride,residual,match",
    [
        ((14, 14, 256), (256, 9 * 256), 1, None, r"\(N, S, S, C\)"),
        ((2, 7, 6, 64), (64, 9 * 64), 1, None, "square"),
        ((2, 7, 7, 64), (9 * 64, 64), 1, None, "weights"),  # the HWIO matrix, not packed
        ((2, 7, 7, 64), (64, 9 * 32), 1, None, "weights"),
        ((2, 7, 7, 48), (64, 9 * 48), 1, None, "multiples of 32"),  # C
        ((2, 7, 7, 64), (80, 9 * 64), 1, None, "multiples of 32"),  # C_out
        ((2, 9, 9, 64), (64, 9 * 64), 3, None, "stride 3"),
        ((2, 14, 14, 64), (64, 9 * 64), 2, (2, 14, 14, 64), "residual"),  # the input's plane
        ((2, 7, 7, 64), (64, 9 * 64), 1, (2, 7, 7, 32), "residual"),
        ((2**31 // (49 * 64) + 1, 7, 7, 64), (64, 9 * 64), 1, None, "2\\^31"),
    ],
)
def test_conv3x3_i8_shapes_refused(x, w, stride, residual, match):
    with pytest.raises(ValueError, match=match):
        check_conv3x3_i8_shapes(x, w, stride, residual)


@pytest.mark.parametrize(
    "col,w",
    [
        ((4096, 14, 14, 768), (256, 768)),  # the int8-resident stem at batch 256
        ((128, 14, 14, 768), (256, 768)),  # and at batch 8
        ((3, 14, 14, 768), (64, 768)),
        ((3, 14, 14, 768), (160, 768)),
        ((2, 4, 4, 192), (256, 192)),  # K = 192: a partial 128-byte chunk
        ((1, 256), (256, 256)),  # the byte-map preflight
    ],
)
def test_stem_u8_shapes_taken(col, w):
    check_stem_u8_shapes(col, w)


@pytest.mark.parametrize(
    "col,w,match",
    [
        ((2, 14, 14, 768), (768, 256), r"K-major \(C0, K\) expected"),  # the (K, C0) matrix
        ((2, 4, 4, 192), (192, 64), r"K-major \(C0, K\) expected"),
        ((2, 14, 14, 640), (256, 768), "do not match"),
        ((2, 4, 4, 96), (64, 96), "multiple of 64"),  # K % 64
        ((2, 4, 4, 768), (48, 768), "of 32"),  # C0 % 32
        ((2, 4, 4, 768), (256, 768, 1), r"\(C0, K\)"),
        ((2**31 // 4 + 1, 4, 64), (32, 64), "2\\^31"),
    ],
)
def test_stem_u8_shapes_refused(col, w, match):
    with pytest.raises(ValueError, match=match):
        check_stem_u8_shapes(col, w)


@pytest.mark.parametrize(
    "x,w",
    [
        ((100352, 768), (2304, 768)),  # the int8 ViT at batch 64: qkv, out, mlp_in, mlp_out
        ((100352, 768), (768, 768)),
        ((8, 1568, 768), (3072, 768)),
        ((8, 1568, 3072), (768, 3072)),
        ((128, 112, 112, 192), (64, 192)),  # ResNet-18's stem on its im2col rows, K padded
        ((128, 28, 28, 64), (128, 64)),  # and its downsamples
        ((128, 14, 14, 128), (256, 128)),
        ((128, 7, 7, 256), (512, 256)),
    ],
)
def test_int8_gemm_shapes_taken(x, w):
    check_int8_gemm_shapes(x, w)


@pytest.mark.parametrize(
    "x,w,match",
    [
        ((4, 112, 112, 147), (64, 147), "multiple of 64"),  # the stem's K unpadded
        ((4, 768), (768, 2304), r"K-major \(C0, K\) expected"),  # int8_dense's (K, N) weights
        ((4, 768), (48, 768), "of 32"),
        ((4, 640), (256, 768), "do not match"),
    ],
)
def test_int8_gemm_shapes_refused(x, w, match):
    with pytest.raises(ValueError, match=match) as err:
        check_int8_gemm_shapes(x, w)
    assert str(err.value).startswith("int8_gemm kernel:")


@pytest.mark.parametrize(
    "size,stride,padding,lo",
    [
        (56, 2, [(1, 1), (1, 1)], 1),  # ResNet-18's stride-2 convs: not SAME
        (56, 2, "SAME", 0),
        (56, 1, [(1, 1), (1, 1)], 1),
        (7, 1, "SAME", 1),
        (7, 2, [(1, 1), (1, 1)], 1),  # an odd plane: (1, 1) is SAME there
        (14, 2, [(0, 1), (0, 1)], 0),
    ],
)
def test_conv3x3_i8_pads_taken(size, stride, padding, lo):
    assert conv3x3_i8_pad_lo(size, stride, padding) == lo


@pytest.mark.parametrize(
    "size,stride,padding,match",
    [
        (56, 1, "VALID", "side of 54"),
        (56, 1, [(2, 2), (2, 2)], "side of 58"),
        (56, 2, [(2, 2), (2, 2)], "side of 29"),
        (56, 1, [(1, 1), (0, 2)], "both axes alike"),
    ],
)
def test_conv3x3_i8_pads_refused(size, stride, padding, match):
    with pytest.raises(ValueError, match=match):
        conv3x3_i8_pad_lo(size, stride, padding)


def _views(B, H, N):
    """(shape, strides) of a contiguous (B, H, N, 64) tensor and of the (B, H, N, 64)
    view of a (B, N, 3·H·64) projection, as ``Attention`` hands q, k and v over."""
    contiguous = torch.empty((B, H, N, HEAD_DIM), dtype=torch.bfloat16)
    qkv = torch.empty((B, N, 3 * H * HEAD_DIM), dtype=torch.bfloat16)
    view = qkv[..., : H * HEAD_DIM].view(B, N, H, HEAD_DIM).transpose(1, 2)
    return [(tuple(t.shape), t.stride()) for t in (contiguous, view)]


@pytest.mark.parametrize("B,H,N", [(8, 12, 1568), (1, 12, 1568), (2, 3, 100), (1, 1, 1)])
def test_flash_operand_taken(B, H, N):
    for shape, strides in _views(B, H, N):
        check_flash_operand("q", shape, strides, 0, (B, H, N, HEAD_DIM))
        check_flash_operand("q", shape, strides, 4096 + 16, (B, H, N, HEAD_DIM))


@pytest.mark.parametrize(
    "shape,strides,ptr,expected,match",
    [
        ((2, 3, 100, 64), (19200, 6400, 64, 1), 0, (2, 3, 101, 64), "!="),
        ((2, 3, 100, 32), (9600, 3200, 32, 1), 0, (2, 3, 100, 32), "head_dim"),
        ((2, 3, 100, 64), (19200, 6400, 1, 100), 0, (2, 3, 100, 64), "unit stride"),
        ((2, 3, 100, 64), (19200, 6400, 64, 1), 8, (2, 3, 100, 64), "16-byte aligned"),
        ((2, 3, 100, 64), (20400, 6800, 68, 1), 0, (2, 3, 100, 64), "multiples of 8"),
        ((2, 3, 100, 64), (19204, 6400, 64, 1), 0, (2, 3, 100, 64), "multiples of 8"),
        ((2, 3, 100, 64), (0, 6400, 64, 1), 0, (2, 3, 100, 64), "broadcast"),
        ((2, 3, 100, 64), (19200, 0, 64, 1), 0, (2, 3, 100, 64), "broadcast"),
        ((2, 3, 100, 64), (19200, 6400, -64, 1), 0, (2, 3, 100, 64), "reversed"),
    ],
)
def test_flash_operand_refused(shape, strides, ptr, expected, match):
    with pytest.raises(ValueError, match=match):
        check_flash_operand("k", shape, strides, ptr, expected)


def test_flash_operand_ignores_the_stride_of_a_single_element():
    """A dimension of one element is never stepped over: a zero stride there is no
    broadcast."""
    check_flash_operand("v", (1, 1, 100, 64), (0, 0, 64, 1), 0, (1, 1, 100, 64))


@pytest.mark.parametrize("sm_scale", [0.125, 1.0, 1e-6])
def test_flash_scale_taken(sm_scale):
    check_flash_scale(sm_scale)


@pytest.mark.parametrize("sm_scale", [0.0, -0.125, float("nan")])
def test_flash_scale_refused(sm_scale):
    with pytest.raises(ValueError, match="positive"):
        check_flash_scale(sm_scale)


def test_cpu_tensors_take_the_plain_paths_whatever_their_shape():
    """The checks guard the kernels only: on the CPU a width no kernel takes goes
    through the plain versions."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 5, 5, 24), generator=gen)
    k = torch.randn((3, 3, 24, 20), generator=gen)
    launches = (conv3x3_bn_act.launches, flash_lean.launches)
    out = conv3x3_bn_act(x, k, torch.ones(20), torch.zeros(20))
    assert out.shape == (1, 5, 5, 20)
    q = torch.randn((1, 2, 9, 16), generator=gen)
    assert flash_lean(q, q, q).shape == (1, 2, 9, 16)
    assert flash_lean(q, q, q, sm_scale=-0.25).shape == (1, 2, 9, 16)  # any scale on the CPU
    assert (conv3x3_bn_act.launches, flash_lean.launches) == launches


@pytest.mark.parametrize(
    "B,H,N",
    [(16, 12, 1568), (1, 1, 1), (2, 3, 100), (65535, 1, 5), (65535, 1, 1), (1, 65535, 1), (65535, 65535, 1),
     (2, 3, 129), (2, 3, 128), (2, 3, 64)],
)
def test_flash_grad_operands_taken(B, H, N):
    check_flash_grad_operands(B, H, N, {"lse": ((B, H, N), True), "di": ((B, H, N), True)})


@pytest.mark.parametrize(
    "B,H,N,stats,match",
    [
        (2, 3, 100, {"lse": ((2, 3, 99), True)}, "lse"),
        (2, 3, 100, {"lse": ((2, 3, 100), True), "di": ((3, 2, 100), True)}, "di"),
        (2, 3, 100, {"lse": ((2, 3, 100), False)}, "contiguous"),
        (2, 3, 100, {"lse": ((2, 3, 100), True), "di": ((2, 3, 100), False)}, "contiguous"),
        (65536, 1, 8, {"lse": ((65536, 1, 8), True)}, "grid"),
        (1, 65536, 8, {"lse": ((1, 65536, 8), True)}, "grid"),
        (65536, 1, 1, {"lse": ((65536, 1, 1), True)}, "grid"),
        (1, 65536, 1, {"lse": ((1, 65536, 1), True)}, "grid"),
        (65535, 65536, 1, {"lse": ((65535, 65536, 1), True)}, "grid"),
        (65536, 65535, 1, {"lse": ((65536, 65535, 1), True)}, "grid"),
        (1, 1, 0, {"lse": ((1, 1, 0), True)}, "grid"),
    ],
)
def test_flash_grad_operands_refused(B, H, N, stats, match):
    with pytest.raises(ValueError, match=match):
        check_flash_grad_operands(B, H, N, stats)


@pytest.mark.parametrize("k,taps", [(-1, 1), (0, 1), (1, 1), (2, 3), (3, 3), (4, 5), (5, 5), (30, 31), (31, 31)])
def test_median_taps_as_the_plain_filter(k, taps):
    assert median_taps(k) == taps


@pytest.mark.parametrize(
    "shape,k",
    [((256, 250, 6), 5), ((3, 2048, 6), 3), ((1, 1, 6), 31), ((2, 100_000, 6), 7),
     ((1, 9685, 6), 1_000_001), ((1, 50_000, 6), 8661)],
)
def test_fused_window_operand_taken(shape, k):
    """Any window length and any kernel size the plain featurizer takes, as long as one
    tile's span fits in shared memory (always for windows up to 9685 samples)."""
    check_fused_window_operand(shape, torch.float32, True, k)


@pytest.mark.parametrize(
    "shape,dtype,contiguous,k,match",
    [
        ((2, 250, 6), torch.float64, True, 5, "float32"),
        ((2, 250), torch.float32, True, 5, "3-D"),
        ((2, 250, 3), torch.float32, True, 5, "contiguous"),
        ((2, 250, 6), torch.float32, False, 5, "contiguous"),
        ((0, 250, 6), torch.float32, True, 5, "contiguous"),
        ((1, 50_000, 6), torch.float32, True, 8663, "shared memory"),
    ],
)
def test_fused_window_operand_refused(shape, dtype, contiguous, k, match):
    with pytest.raises(ValueError, match=match):
        check_fused_window_operand(shape, dtype, contiguous, k)


@pytest.mark.parametrize(
    "B,T,k,plan",
    [
        # the serving path: 8 samples a lane, rows of 32·8 + 2·2 floats for 6 channels
        (256, 250, 5, LaunchPlan("registers", 256, 192, 6 * 260 * 4, 8)),
        (8, 250, 5, LaunchPlan("registers", 8, 192, 6 * 260 * 4, 8)),
        (8192, 250, 4, LaunchPlan("registers", 8192, 192, 6 * 260 * 4, 8)),
        # the register form's edges: a lane's share rounded up to a power of two, up to 32
        (3, 1, 5, LaunchPlan("registers", 3, 192, 6 * 36 * 4, 1)),
        (3, 32, 5, LaunchPlan("registers", 3, 192, 6 * 36 * 4, 1)),
        (3, 33, 5, LaunchPlan("registers", 3, 192, 6 * 68 * 4, 2)),
        (3, 256, 31, LaunchPlan("registers", 3, 192, 6 * 260 * 4, 8)),
        (3, 257, 31, LaunchPlan("registers", 3, 192, 6 * 516 * 4, 16)),
        (3, 1023, 9, LaunchPlan("registers", 3, 192, 6 * 1028 * 4, 32)),
        (3, 1024, 8661, LaunchPlan("registers", 3, 192, 6 * 1028 * 4, 32)),
        # past it, the tiled form: a tile of 1024 samples and the median's halo
        (3, 1025, 5, LaunchPlan("tiled", 3, 192, 1025 * 6 * 4, 0)),
        (3, 2048, 3, LaunchPlan("tiled", 3, 192, 1026 * 6 * 4, 0)),
        (2, 100_000, 7, LaunchPlan("tiled", 2, 192, 1030 * 6 * 4, 0)),
        # the longest spans the operand check takes
        (1, 9685, 1_000_001, LaunchPlan("tiled", 1, 192, 9685 * 6 * 4, 0)),
        (1, 50_000, 8661, LaunchPlan("tiled", 1, 192, 9684 * 6 * 4, 0)),
    ],
)
def test_fused_window_launch_plan(B, T, k, plan):
    assert launch_plan(B, T, k) == plan


def test_fused_window_register_form_covers_each_window_once():
    """For every T of the register form, the fewest samples a lane that is a power of
    two covers the window, and the block's rows fit the 48 KB of static shared memory."""
    for T in range(1, 32 * MAX_LANE + 1):
        plan = launch_plan(1, T, 5)
        n = plan.per_lane
        assert plan.form == "registers" and n & (n - 1) == 0 and n <= MAX_LANE
        assert 32 * n >= T and (n == 1 or 16 * n < T)
        assert plan.smem_bytes <= 48 * 1024
    assert launch_plan(1, 32 * MAX_LANE + 1, 5).form == "tiled"
    assert launch_plan(1, 9685, 10**9).smem_bytes <= SMEM_MAX < launch_plan(1, 9686, 10**9).smem_bytes


def test_fused_window_refuses_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="CUDA"):
        featurize_windows_auto(torch.empty((2, 250, 6), device="meta"))


def test_flash_f32_operand_rows_of_16_bytes():
    """The dQ kernel reads the forward's f32 output in 16-byte chunks: strides in
    multiples of 4 elements are taken, others refused."""
    check_flash_operand("out_f32", (2, 3, 100, 64), (19200, 64, 192, 1), 0, (2, 3, 100, 64), itemsize=4)
    check_flash_operand("out_f32", (1, 1, 5, 64), (0, 0, 68, 1), 16, (1, 1, 5, 64), itemsize=4)
    with pytest.raises(ValueError, match="multiples of 4"):
        check_flash_operand("out_f32", (1, 1, 5, 64), (0, 0, 66, 1), 0, (1, 1, 5, 64), itemsize=4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_flash_operand("out_f32", (1, 1, 5, 64), (0, 0, 68, 1), 8, (1, 1, 5, 64), itemsize=4)
