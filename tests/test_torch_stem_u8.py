"""The port's uint8 patch-major stem (``tpuhar_torch/ops/stem.py``) vs the JAX package's
``tpuhar/ops/stem.py``, on the fixture of ``tests/test_stem.py`` (3×64×64×3 uint8 with
a block of black pixels, p=16, C0=32), and the byte-map preflight twin. The port takes
the weights K-major, ``(C0, K)`` (``pack_stem_u8``); the JAX package ``(K, C0)``.

The CPU path is the plain version: the byte map in uint8, the GEMM in float64. Every
768-term int8 dot product is exact in either accumulator, and the epilogue runs the
same f32 ops in the same order, so the port equals JAX's int8-MXU ``stem_gemm_u8`` bit
for bit, in f32 and in int8 out.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar.ops import quant as Q
from tpuhar.ops.stem import stem_gemm_u8 as jax_stem_gemm_u8
from tpuhar.ops.stem import pack_stem_weights as jax_pack_stem_weights
from tpuhar.ops.stem import stem_gemm_u8_pallas, to_patch_major
from tpuhar_torch.ops import stem as stem_mod
from tpuhar_torch.ops.stem import pack_stem_u8, pack_stem_weights, stem_gemm_u8, verify_byte_map

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture():
    npr = np.random.default_rng(0)
    p, c0 = 16, 32
    u8 = (npr.random((3, 64, 64, 3)) * 255).astype(np.uint8)
    u8[0, :16, :16] = 0  # the u8 = 0 clip corner
    kernel = npr.normal(0, 0.05, (p, p, 3, c0)).astype(np.float32)
    w_q, w_s = Q.quantize_weights(jnp.asarray(kernel), axis=-1)
    bias = npr.normal(0, 0.1, (c0,)).astype(np.float32)
    x_q = jnp.clip(jnp.asarray(u8).astype(jnp.int16) - 128, -127, 127).astype(jnp.int8)
    y_conv = np.maximum(
        np.asarray(Q.int8_conv(x_q, w_q, jnp.float32(1.0), w_s, strides=(p, p), padding="VALID")) + bias, 0
    )
    col = to_patch_major(u8, p)
    w_kc = np.array(w_q).reshape(p * p * 3, c0)  # the JAX package's (K, C0)
    return dict(
        col=col, w_kc=w_kc, w_packed=pack_stem_u8(torch.from_numpy(np.array(w_q))).numpy(),
        w_scale=np.array(w_s).reshape(-1), bias=bias, y_conv=y_conv,
    )


def _port(f, **kw):
    return stem_gemm_u8(
        torch.from_numpy(f["col"]), torch.from_numpy(f["w_packed"]),
        torch.from_numpy(f["w_scale"]), torch.from_numpy(f["bias"]), **kw,
    ).numpy()


@pytest.mark.parametrize("out_scale", [None, 0.07, 0.013])
@pytest.mark.parametrize("relu", [True, False])
def test_matches_jax_stem_gemm_u8(fixture, out_scale, relu):
    """The int8 path's map (``sub=128, clip_lo=-127``), f32 out and requantized."""
    f = fixture
    out_dtype = jnp.float32 if out_scale is None else jnp.int8
    want = np.asarray(
        jax_stem_gemm_u8(
            jnp.asarray(f["col"]), jnp.asarray(f["w_kc"]), jnp.asarray(f["w_scale"]),
            jnp.asarray(f["bias"]), sub=128, clip_lo=-127, relu=relu, out_scale=out_scale,
            out_dtype=out_dtype, mxu_dtype=jnp.int8,
        )
    )
    got = _port(f, relu=relu, out_scale=out_scale)
    assert got.dtype == np.dtype(out_dtype) and got.shape == (3, 4, 4, 32)
    np.testing.assert_array_equal(got, want)  # exact: same integers, same f32 ops


def test_matches_pallas_interpret_and_int8_conv(fixture):
    f = fixture
    want = np.asarray(
        stem_gemm_u8_pallas(
            jnp.asarray(f["col"]), jnp.asarray(f["w_kc"]), jnp.asarray(f["w_scale"]),
            jnp.asarray(f["bias"]), mxu_dtype=jnp.int8, interpret=True,
        )
    )
    got = _port(f)
    np.testing.assert_allclose(got, want, atol=1e-4)  # the bound tests/test_stem.py uses
    np.testing.assert_allclose(got, f["y_conv"].reshape(got.shape), atol=1e-4)


def test_int8_out_equals_quantize_activations(fixture):
    f = fixture
    got = _port(f, out_scale=0.07)
    want = np.asarray(Q.quantize_activations(jnp.asarray(f["y_conv"]), jnp.float32(0.07)))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    np.testing.assert_array_equal(  # and JAX's own fused requant
        got,
        np.asarray(
            jax_stem_gemm_u8(
                jnp.asarray(f["col"]), jnp.asarray(f["w_kc"]), jnp.asarray(f["w_scale"]),
                jnp.asarray(f["bias"]), out_scale=0.07, out_dtype=jnp.int8,
            )
        ),
    )


def test_byte_map_exhaustive():
    col = torch.arange(256, dtype=torch.uint8).reshape(1, 1, 1, 256)
    got = stem_gemm_u8(
        col, torch.eye(256, dtype=torch.int8), torch.ones(256), torch.zeros(256), relu=False
    ).reshape(256)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), np.clip(np.arange(256) - 128, -127, 127))


def test_verify_byte_map_passes_and_catches_a_broken_route(monkeypatch):
    verify_byte_map("cpu")
    orig = stem_mod.stem_gemm_u8

    def broken(col, w, scale, bias, **kw):  # a route that flips the sign of the codes
        return -orig(col, w, scale, bias, **kw)

    monkeypatch.setattr(stem_mod, "stem_gemm_u8", broken)
    with pytest.raises(RuntimeError, match="byte map is WRONG"):
        verify_byte_map("cpu")


def test_int8_wire_and_bad_clip_raise(fixture):
    """int8 input is the centered wire: its codes go into the GEMM as they are, as the
    JAX package's ``pre_centered`` branch takes them (``tests/test_torch_stem_wire.py``
    holds the wire end to end); any other non-uint8 pixels raise."""
    f = fixture
    col = torch.from_numpy(f["col"])
    args = (torch.from_numpy(f["w_packed"]), torch.from_numpy(f["w_scale"]), torch.from_numpy(f["bias"]))
    want = np.asarray(jax_stem_gemm_u8(
        jnp.asarray(f["col"].view(np.int8)), jnp.asarray(f["w_kc"]), jnp.asarray(f["w_scale"]),
        jnp.asarray(f["bias"]), out_scale=0.07, out_dtype=jnp.int8,
    ))
    np.testing.assert_array_equal(stem_gemm_u8(col.view(torch.int8), *args, out_scale=0.07).numpy(), want)
    with pytest.raises(TypeError, match="uint8 patch-major pixels"):
        stem_gemm_u8(col.float(), *args)


def test_pack_stem_weights_matches_patch_major_order(fixture):
    """Row r of the packed matrix multiplies byte r of a patch-major row."""
    kernel = np.arange(4 * 4 * 3 * 2).reshape(4, 4, 3, 2)
    frames = np.arange(4 * 4 * 3, dtype=np.uint8).reshape(1, 4, 4, 3)
    col = to_patch_major(frames, 4).reshape(-1)
    np.testing.assert_array_equal(
        col @ pack_stem_weights(kernel), np.einsum("hwc,hwcn->n", frames[0].astype(np.int64), kernel)
    )


def test_pack_stem_u8_is_the_k_major_transpose(fixture):
    """``pack_stem_u8`` is the JAX package's ``pack_stem_weights`` transposed to
    ``(C0, K)``, contiguous, and the plain stem on it equals the ``(K, C0)`` product."""
    rng = np.random.default_rng(3)
    kernel = rng.integers(-127, 128, (16, 16, 3, 32), dtype=np.int8)
    got = pack_stem_u8(torch.from_numpy(kernel))
    assert got.shape == (32, 768) and got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pack_stem_weights(jnp.asarray(kernel))).T)
    f = fixture
    x = np.clip(f["col"].astype(np.int64) - 128, -127, 127).reshape(-1, 768)
    acc = stem_gemm_u8(
        torch.from_numpy(f["col"]), torch.from_numpy(f["w_packed"]), torch.ones(32), torch.zeros(32), relu=False,
    ).numpy().reshape(-1, 32)
    np.testing.assert_array_equal(acc, (x @ f["w_kc"].astype(np.int64)).astype(np.float32))
