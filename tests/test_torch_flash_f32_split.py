"""The f32 flash backward kernels' split-TF32 arithmetic on the CPU, in the style of
``tests/test_torch_conv3x3_f32.py``: each kernel's products emulated in float64 with
``split_tf32`` against the plain backward in float64.

Both kernels (``tpuhar_torch/csrc/flash_attn_bwd_f32.cu``) compute S and dP as three TF32
products each (``lo_a·hi_b + hi_a·lo_b + hi_a·hi_b``), then P = exp(S·scale − lse) and
dS = P (dP − di)·scale, and add, for each stage of 64 rows, the three products over the
stage's rows into a fresh accumulator: the dK/dV kernel S^T = K Q^T and dP^T = V dO^T,
then dV += P^T dO and dK += dS^T Q over stages of 64 query rows; the dQ kernel S = Q K^T
and dP = dO V^T, then dQ += dS K over stages of 64 key rows. Their hi is
``split_tf32``'s; their lo is v − hi unrounded, which the tensor cores read as TF32 (the
top 19 bits). The A of the last products comes straight from the S and dP accumulators'
registers, so its k-th column is stage row ``8 j + sigma(k)`` of each group of eight; the
kernels store the B tiles' stage rows in that order. Stage rows past N arrive as zeros,
and P is 0 there: the dK/dV kernel gives those query rows lse = +inf, the dQ kernel
masks the key columns. The forward kernel (``tpuhar_torch/csrc/flash_attn_f32.cu``) runs
S = Q K^T the same way over stages of 64 key rows, the online softmax on the stage's
scores (the running max m, alpha = exp((m_old − m)·scale), l = alpha·l + the row sums,
-inf in the key columns past N), and each stage's P V, A straight from the S accumulator
and V's [d][key] rows in the same key order, into a fresh sum that is added as
O = alpha·O + O_stage; then O / l and m·scale + ln l. The kernels themselves run only on
the card (``tests/test_torch_kernels_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuhar.ops.flash_lean import flash_lean as jax_flash_lean
from tpuhar_torch.ops.conv3x3 import split_tf32
from tpuhar_torch.ops.flash_lean import _reference_sums, flash_lean_backward_reference, flash_lean_with_stats

torch.set_num_threads(2)

SIGMA = (0, 2, 4, 6, 1, 3, 5, 7)  # A's column k of a k-step is the accumulator's column SIGMA[k]
STAGE = 64  # rows of one stage: the K of the products of one fresh accumulator (dV, dK; dQ)
SM_SCALE = 0.125


def _halves(x: torch.Tensor):
    """x's f32 value as the kernel's two TF32 halves, in float64: hi rounded
    (``split_tf32``), lo = x − hi (exact in f32) as the tensor cores read it, its low 13
    bits dropped."""
    x = x.float()
    hi = split_tf32(x)[0]
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi.double(), lo.double()


def _split_product(a: torch.Tensor, b: torch.Tensor, *, single: bool = False) -> torch.Tensor:
    """a @ b as the kernel forms it, each product and sum exact in float64: lo·hi, hi·lo
    and hi·hi (lo·lo dropped), or with ``single`` only hi·hi, one TF32 pass."""
    a_hi, a_lo = _halves(a)
    b_hi, b_lo = _halves(b)
    if single:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _query_order(n: int) -> torch.Tensor:
    """The order of the stage rows in the kernels' [d][row] tiles (dK/dV: query rows, dQ:
    key rows): position ``8 j + k`` holds row ``8 j + sigma(k)``."""
    return torch.tensor([8 * (p // 8) + SIGMA[p % 8] for p in range(n)])


def _a_from_accumulator(acc: torch.Tensor) -> torch.Tensor:
    """The register A operands that the kernel's ``acc_to_a`` builds from a 64 x 64
    accumulator (two halves of four k-steps), put back together as a 64 x 64 matrix in
    A's column order. Accumulator:
    thread (warp w, lane l) holds, for each 8-column group j, d[4j], d[4j+1] = row 16 w + l/4,
    columns 8 j + 2 (l%4), +1, and d[4j+2], d[4j+3] the same columns of row + 8. Register A
    (tf32, k = 8): a[0] = row 16 w + l/4, column l%4; a[1] row + 8; a[2], a[3] the same rows
    at column l%4 + 4. The kernel takes a = {d[4j], d[4j+2], d[4j+1], d[4j+3]}."""
    a = torch.full_like(acc, float("nan"))
    for warp in range(4):
        for lane in range(32):
            r, t = 16 * warp + lane // 4, lane % 4
            for j in range(acc.shape[1] // 8):
                d = (acc[r, 8 * j + 2 * t], acc[r, 8 * j + 2 * t + 1], acc[r + 8, 8 * j + 2 * t],
                     acc[r + 8, 8 * j + 2 * t + 1])
                frag = (d[0], d[2], d[1], d[3])
                a[r, 8 * j + t], a[r + 8, 8 * j + t] = frag[0], frag[1]
                a[r, 8 * j + t + 4], a[r + 8, 8 * j + t + 4] = frag[2], frag[3]
    return a


def _emulated_dkv(q, k, v, dout, lse, di, *, single: bool = False):
    """(dk, dv) of the dK/dV kernel on f32 operands, each product and sum in float64: lse
    and di as the kernel reads them (f32), query rows padded to whole stages with zeros
    and lse = +inf, each stage's products in the tiles' query order. Also returns P."""
    N = q.shape[2]
    n_pad = -(-N // STAGE) * STAGE
    q, dout = (F.pad(t, (0, 0, 0, n_pad - N)) for t in (q, dout))
    lse = F.pad(lse.float().double(), (0, n_pad - N), value=float("inf"))
    di = F.pad(di.float().double(), (0, n_pad - N))
    st = _split_product(k, q.mT, single=single)  # (B, H, N keys, n_pad queries)
    dpt = _split_product(v, dout.mT, single=single)
    p = torch.exp(st * SM_SCALE - lse[..., None, :])
    ds = p * (dpt - di[..., None, :]) * SM_SCALE
    order = _query_order(n_pad)
    dk = dv = 0.0
    for s0 in range(0, n_pad, STAGE):
        rows = order[s0:s0 + STAGE]  # a fresh accumulator a stage, added in f32 registers
        dv = dv + _split_product(p[..., rows], dout[..., rows, :], single=single)
        dk = dk + _split_product(ds[..., rows], q[..., rows, :], single=single)
    return dk, dv, p


def _emulated_dq(q, k, v, dout, lse, di, *, single: bool = False):
    """dq of the dQ kernel on f32 operands, each product and sum in float64: lse and di
    as the kernel reads them (f32), key rows padded to whole stages with zeros and P = 0
    in the key columns past N, each stage's dS K products into a fresh sum, A's columns
    and K's [d][key] rows in the tiles' key order. Also returns P."""
    N = k.shape[2]
    n_pad = -(-N // STAGE) * STAGE
    k, v = (F.pad(t, (0, 0, 0, n_pad - N)) for t in (k, v))
    s = _split_product(q, k.mT, single=single)  # (B, H, N queries, n_pad keys)
    dp = _split_product(dout, v.mT, single=single)
    p = torch.exp(s * SM_SCALE - lse.float().double()[..., None])
    p[..., N:] = 0.0  # the kernel's mask: exp(-lse) may overflow in f32 there
    ds = p * (dp - di.float().double()[..., None]) * SM_SCALE
    order = _query_order(n_pad)
    dq = 0.0
    for s0 in range(0, n_pad, STAGE):
        keys = order[s0:s0 + STAGE]  # a fresh accumulator a stage, added in f32 registers
        dq = dq + _split_product(ds[..., keys], k[..., keys, :], single=single)
    return dq, p


def _emulated_forward(q, k, v, *, single: bool = False):
    """(out, lse) of the forward kernel on f32 operands, each product and sum in float64:
    key rows padded to whole stages with zeros and -inf scores in the key columns past N;
    a stage at a time the running max m, alpha and l, P (rounded to f32, as the kernel
    holds it) split with A's columns and V's [d][key] rows in the tiles' key order, its
    P V into a fresh sum added as O = alpha O + O_stage; then O / l and m scale + ln l."""
    N = k.shape[2]
    n_pad = -(-N // STAGE) * STAGE
    k, v = (F.pad(t, (0, 0, 0, n_pad - N)) for t in (k, v))
    s = _split_product(q, k.mT, single=single)  # (B, H, N queries, n_pad keys)
    s[..., N:] = float("-inf")
    order = _query_order(n_pad)
    m = torch.full(s.shape[:-1], float("-inf"), dtype=torch.float64)
    l = torch.zeros_like(m)
    o = torch.zeros((*s.shape[:-1], v.shape[-1]), dtype=torch.float64)
    for s0 in range(0, n_pad, STAGE):
        m_new = torch.maximum(m, s[..., s0:s0 + STAGE].amax(-1))  # finite: every stage starts below N
        alpha = torch.exp((m - m_new) * SM_SCALE)  # 0 on the first stage
        p = torch.exp((s - m_new[..., None]) * SM_SCALE)  # the stage's columns are read below
        keys = order[s0:s0 + STAGE]
        l = l * alpha + p[..., s0:s0 + STAGE].sum(-1)
        o = o * alpha[..., None] + _split_product(p[..., keys], v[..., keys, :], single=single)
        m = m_new
    return o / l[..., None], m * SM_SCALE + torch.log(l)


def _case(B, H, N, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn((B, H, N, 64), generator=gen) for _ in range(4))
    out, lse, _ = flash_lean_with_stats(q.double(), k.double(), v.double(), SM_SCALE)
    di = (out * dout.double()).sum(-1)
    return q, k, v, dout, lse, di


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("B,H,N", [(1, 2, 1568), (2, 1, 200)])
def test_split_dkv_matches_the_float64_backward(B, H, N):
    """The kernel's arithmetic within 1e-6 of the largest element of dk and dv against the
    plain backward in float64 (what is left: the dropped lo·lo, what the splits leave
    over, lse and di in f32; the kernel's f32 sums add f32 rounding on top, held to 1e-5
    on the card); query rows past N get P = 0 and add nothing; a single TF32 pass
    (hi·hi) misses by more than 1e-5."""
    q, k, v, dout, lse, di = _case(B, H, N, seed=N)
    _, want_dk, want_dv = flash_lean_backward_reference(q.double(), k.double(), v.double(), dout.double(), SM_SCALE)
    dk, dv, p = _emulated_dkv(q, k, v, dout, lse, di)
    assert _rel(dk, want_dk) <= 1e-6 and _rel(dv, want_dv) <= 1e-6
    assert not p[..., N:].any()  # rows past N: exp(0 − inf)
    dk1, dv1, _ = _emulated_dkv(q, k, v, dout, lse, di, single=True)
    assert _rel(dk1, want_dk) > 1e-5 and _rel(dv1, want_dv) > 1e-5


@pytest.mark.parametrize("B,H,N", [(1, 2, 1568), (2, 1, 200)])
def test_split_dq_matches_the_float64_backward(B, H, N):
    """The dQ kernel's arithmetic within 1e-6 of dq's largest element against the plain
    backward in float64 (what is left as for dK/dV above); key columns past N get P = 0
    and add nothing; a single TF32 pass (hi·hi) misses by more than 1e-5."""
    q, k, v, dout, lse, di = _case(B, H, N, seed=N + 1)
    want_dq = flash_lean_backward_reference(q.double(), k.double(), v.double(), dout.double(), SM_SCALE)[0]
    dq, p = _emulated_dq(q, k, v, dout, lse, di)
    assert _rel(dq, want_dq) <= 1e-6
    assert not p[..., N:].any()  # key columns past N: masked
    dq1, _ = _emulated_dq(q, k, v, dout, lse, di, single=True)
    assert _rel(dq1, want_dq) > 1e-5


@pytest.mark.parametrize("B,H,N", [(1, 2, 1568), (2, 1, 65), (2, 1, 129), (1, 2, 200)])
def test_split_forward_matches_the_float64_forward(B, H, N):
    """The forward kernel's arithmetic within 1e-6 of the largest output element, and its
    log-sum-exp within 1e-6 absolute, against the plain forward in float64 (what is left:
    the dropped lo·lo, what the splits leave over, P in f32); key columns past N add
    nothing (a stage of one key row at 65, a block of one query row at 129); a single TF32
    pass (hi·hi) misses the output by more than 1e-5."""
    gen = torch.Generator().manual_seed(N + 2)
    q, k, v = (torch.randn((B, H, N, 64), generator=gen) for _ in range(3))
    want, want_lse = _reference_sums(q.double(), k.double(), v.double(), SM_SCALE)
    out, lse = _emulated_forward(q, k, v)
    assert _rel(out, want) <= 1e-6
    assert (lse - want_lse).abs().max().item() <= 1e-6
    out1, _ = _emulated_forward(q, k, v, single=True)
    assert _rel(out1, want) > 1e-5


def test_split_forward_matches_jax_interpret():
    """The forward kernel's arithmetic against the JAX package's ``flash_lean`` in
    interpret mode on the same f32 numpy inputs, with the kernel's staging (128-row query
    blocks, 64-row key blocks, the last one masked past N) at a ragged N: within 1e-5 of
    the largest element."""
    rng = np.random.default_rng(27)
    q, k, v = (rng.standard_normal((1, 2, 200, 64)).astype(np.float32) for _ in range(3))
    want = np.array(jax_flash_lean(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=SM_SCALE,
                                   block_q=128, block_k=64, interpret=True))
    out, _ = _emulated_forward(*(torch.from_numpy(t) for t in (q, k, v)))
    assert _rel(out, torch.from_numpy(want).double()) <= 1e-5


def test_accumulator_columns_make_the_permuted_a_operand():
    """``acc_to_a``'s register shuffle: A's column 8 j + k is the accumulator's column
    8 j + sigma(k), and the producer's [d][query] tiles (position 8 j + 4 par + i holds
    query row 8 j + 2 i + par) put B's rows in the same order."""
    acc = torch.randn((64, STAGE), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    order = _query_order(STAGE)
    assert torch.equal(_a_from_accumulator(acc), acc[:, order])
    tiles = torch.empty(STAGE, dtype=torch.long)
    for j in range(STAGE // 8):
        for par in range(2):
            for i in range(4):
                tiles[8 * j + 4 * par + i] = 8 * j + 2 * i + par
    assert torch.equal(tiles, order)


def test_permuted_product_equals_the_unpermuted_one():
    """A with its columns and B with its rows in the tiles' order give the same product,
    bit for bit on values whose sums are exact in any order."""
    gen = torch.Generator().manual_seed(1)
    a = torch.randint(-64, 65, (64, 3 * STAGE), generator=gen).double()
    b = torch.randint(-64, 65, (3 * STAGE, 64), generator=gen).double()
    order = _query_order(3 * STAGE)
    assert sorted(order.tolist()) == list(range(3 * STAGE))
    assert torch.equal(a[:, order] @ b[order], a @ b)
