"""The binary / QAT slice's packing, quantizers and kernel 8's plain version
against the JAX package, on the CPU.

Bit-exact throughout, against the JAX package's jitted functions (under
``jit`` XLA multiplies by the f32 reciprocal of a constant divisor, which
the port does too).  One thing differs by design: f32 sums are added in
another order by XLA and by PyTorch.  So the initialisers, whose scales are
means, are fed dyadic weights (multiples of 2^-10 below 1/2 in magnitude,
at most 2^14 of them), on which every partial sum is exact in f32 and the
order cannot matter; then every output bit must agree.  On random normal
weights the codes must still agree and the scales within 1e-6 relative.
Kernel 8's plain version is held exactly to the Pallas kernel in interpret
mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops import packing as jpk
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.pallas.binary_gemm import xnor_gemm_pallas
from bitorch_engine_tpu_torch.ops import packing as tpk
from bitorch_engine_tpu_torch.ops import quant as tq
from bitorch_engine_tpu_torch.ops.cuda import binary_gemm as tbg

SHAPES = [(64, 96), (96, 64), (10, 1000)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _dyadic(rng, shape):
    return (rng.integers(-511, 512, shape) * 2.0**-10).astype(np.float32)


def _words(a):
    """JAX uint32 words as the port's int32 (the same bits)."""
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("k", [32, 100, 1000])
def test_pack_unpack_signs_bit_exact(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((5, 3, k)).astype(np.float32)
    x[0, 0, :4] = [0.0, -0.0, np.nan, -1e-30]
    jx, pad = jpk.pad_to_multiple(jnp.asarray(x), 2, 32, value=-1.0)
    tx, tpad = tpk.pad_to_multiple(_t(x), 2, 32, value=-1.0)
    assert pad == tpad
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    jw = _words(jpk.pack_signs(jx))
    tw = tpk.pack_signs(tx)
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(tpk.unpack_signs(tw).numpy(),
                                  np.asarray(jpk.unpack_signs(jnp.asarray(jw.view(np.uint32)))))
    np.testing.assert_array_equal(tpk.unpack_signs(tw, torch.bfloat16).float().numpy(),
                                  tpk.unpack_signs(tw).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("num_bits,scale", [(8, 1.0), (4, 1.0), (8, 1e-9)])
def test_nv_tensor_quant_bit_exact(shape, num_bits, scale):
    """Max (not abs-max), true division, round half to even; at amax <=
    2^-24 only the returned scale becomes 1."""
    rng = np.random.default_rng(num_bits + len(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jqv, jscale = jq.nv_tensor_quant(jnp.asarray(x), num_bits=num_bits)
    tqv, tscale = tq.nv_tensor_quant(_t(x), num_bits=num_bits)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    assert tscale.item() == float(jscale)
    if scale < 1e-6:
        assert tscale.item() == 1.0 and np.abs(tqv.numpy()).max() == 2 ** (num_bits - 1) - 1


@pytest.mark.parametrize("shape", SHAPES)
def test_act_quantizers_bit_exact(shape):
    rng = np.random.default_rng(7)
    x = _dyadic(rng, shape)
    for jf, tf in ((jq.q8_quantization, tq.q8_quantization), (jq.q4_quantization, tq.q4_quantization)):
        jqv, js = jax.jit(jf)(jnp.asarray(x))
        tqv, ts = tf(_t(x))
        np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
        assert ts.item() == float(js)
        given = np.float32(0.0137)
        np.testing.assert_array_equal(tf(_t(x), torch.tensor(given)).numpy(),
                                      np.asarray(jax.jit(jf)(jnp.asarray(x), jnp.asarray(given))))


@pytest.mark.parametrize("shape", SHAPES)
def test_weight_initialisers_bit_exact(shape):
    rng = np.random.default_rng(11)
    w = _dyadic(rng, shape)
    jb, tb = jq.init_binary_weight(jnp.asarray(w)), tq.init_binary_weight(_t(w))
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    assert tb.data.dtype == torch.int8 and tb.scale_w.item() == float(jb.scale_w)
    assert tb.logical_shape == jb.logical_shape == shape
    for w_bit in (4, 8):
        jn, tn = jq.init_nbit_weight(jnp.asarray(w), w_bit), tq.init_nbit_weight(_t(w), w_bit)
        np.testing.assert_array_equal(tn.data.numpy(), np.asarray(jn.data))
        assert tn.scale_w.item() == float(jn.scale_w) and tn.w_bit == w_bit
    jp, tp = jq.pack_binary_weight(jb), tq.pack_binary_weight(tb)
    np.testing.assert_array_equal(tp.data.numpy(), _words(jp.data))
    assert tp.packed and tp.in_features == jp.in_features == shape[1]
    assert tp.logical_shape == jp.logical_shape and tq.pack_binary_weight(tp) is tp


def test_weight_initialisers_on_normal_weights():
    """Sums in another order: the codes agree, the scales within 1e-6."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((256, 784)) * 0.05).astype(np.float32)
    jb, tb = jq.init_binary_weight(jnp.asarray(w)), tq.init_binary_weight(_t(w))
    np.testing.assert_array_equal(tb.data.numpy(), np.asarray(jb.data))
    np.testing.assert_allclose(tb.scale_w.item(), float(jb.scale_w), rtol=1e-6)
    jn, tn = jq.init_nbit_weight(jnp.asarray(w), 4), tq.init_nbit_weight(_t(w), 4)
    np.testing.assert_array_equal(tn.data.numpy(), np.asarray(jn.data))
    np.testing.assert_allclose(tn.scale_w.item(), float(jn.scale_w), rtol=1e-6)


@pytest.mark.parametrize("m,k,n", [(8, 256, 128), (3, 100, 70), (16, 1024, 40)])
def test_xnor_gemm_ref_matches_the_pallas_kernel(m, k, n):
    """Kernel 8's plain version against ``xnor_gemm_pallas`` in interpret
    mode (both subtract the pad bits): exact, and equal to the ±1 product."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    xp = jpk.pack_signs(jpk.pad_to_multiple(jnp.asarray(x), 1, 32, value=-1.0)[0])
    wp = jpk.pack_signs(jpk.pad_to_multiple(jnp.asarray(w), 1, 32, value=-1.0)[0])
    want = np.asarray(xnor_gemm_pallas(xp, wp, k, interpret=True))
    xw, ww = _t(_words(xp)), _t(_words(wp))
    before = tbg.xnor_gemm.launches
    got = tbg.xnor_gemm(xw, ww, k)  # a CPU tensor: the plain version, not counted
    assert tbg.xnor_gemm.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tbg.xnor_gemm_ref(xw, ww, k).numpy(), want)
    np.testing.assert_array_equal(want, np.where(x >= 0, 1.0, -1.0) @ np.where(w >= 0, 1.0, -1.0).T)


def test_xnor_gemm_refuses_bad_operands():
    x = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="word counts"):
        tbg.xnor_gemm(x, torch.zeros((3, 5), dtype=torch.int32), 128)
    with pytest.raises(ValueError, match="int32"):
        tbg.xnor_gemm(x.float(), torch.zeros((3, 4), dtype=torch.int32), 128)
    with pytest.raises(ValueError, match="k_logical"):
        tbg.xnor_gemm(x, torch.zeros((3, 4), dtype=torch.int32), 129)


def test_popcount_counts_every_bit():
    rng = np.random.default_rng(5)
    w = rng.integers(-2**31, 2**31, 1000, dtype=np.int64).astype(np.int32)
    want = [bin(int(v) & 0xFFFFFFFF).count("1") for v in w]
    np.testing.assert_array_equal(tpk.popcount(_t(w)).numpy(), want)
