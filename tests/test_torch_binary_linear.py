"""The binary / QAT linears and convs of the port against the JAX package,
forward and backward, on the CPU (f32).

Forwards: the ±1 products and the integer products are exact on both
sides, so the binary linear's outputs (unpacked and packed, the CPU branch
``xnor_popcount_mm``) and the QAT linear's are bit-equal.  Backwards
against ``jax.vjp`` of the JAX ops under ``jit`` (as its train step runs
them): the gradients are f32 products and sums in another order, so they
are held within rtol 1e-5 (atol 1e-6 of their largest value); the binary
weight gradient, requantized by ``nv_tensor_quant``, to equal codes but at
most 0.1% differing by one (a value on a rounding boundary may round the
other way).  The convs' JAX side carries a grad shadow of the weight's full
shape (its own ``with_grad_shadow`` gives a binary conv a ``(KH, KW)`` one
that its backward cannot fill).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu import qtensor as jqt
from bitorch_engine_tpu.ops import conv as jconv
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu.ops.binary_linear import binary_linear as jbinary_linear
from bitorch_engine_tpu.ops.qat_linear import qat_linear as jqat_linear
from bitorch_engine_tpu_torch import qtensor as tqt
from bitorch_engine_tpu_torch.ops import conv as tconv
from bitorch_engine_tpu_torch.ops import quant as tq
from bitorch_engine_tpu_torch.ops.binary_linear import binary_linear
from bitorch_engine_tpu_torch.ops.qat_linear import int_matmul, qat_linear


def _t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30), err_msg=what)


def _codes_close(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def _binary_qt(rng, n, k):
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    return jq.init_binary_weight(jnp.asarray(w))


def _port_binary(jb, shadow=None):
    data = np.asarray(jb.data)
    if data.dtype == np.uint32:  # packed words: the port's int32, the same bits
        data = data.view(np.int32)
    return tqt.BinaryQTensor(data=_t(data), scale_w=_t(jb.scale_w), grad_shadow=shadow,
                             packed=jb.packed, in_features=jb.in_features)


@pytest.mark.parametrize("m,k,n", [(8, 96, 40), (33, 100, 64)])
def test_binary_linear_forward_unpacked_and_packed(m, k, n):
    rng = np.random.default_rng(m + k)
    jb = _binary_qt(rng, n, k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :3] = 0.0  # sign(0) = +1 on both sides
    sa, ba = np.float32(0.7), (rng.standard_normal(k) * 0.1).astype(np.float32)
    want = np.asarray(jbinary_linear(jnp.asarray(x), jb, jnp.asarray(sa), jnp.asarray(ba)))
    got = binary_linear(_t(x), _port_binary(jb), _t(sa), _t(ba))
    np.testing.assert_array_equal(got.numpy(), want)
    jp = jq.pack_binary_weight(jb)
    tp = tq.pack_binary_weight(_port_binary(jb))
    want_p = np.asarray(jbinary_linear(jnp.asarray(x), jp, jnp.asarray(sa), jnp.asarray(ba)))
    np.testing.assert_array_equal(want_p, want)
    np.testing.assert_array_equal(binary_linear(_t(x), tp, _t(sa), _t(ba)).numpy(), want)


@pytest.mark.parametrize("packed", [False, True])
def test_binary_linear_backward_matches_jax_vjp(packed):
    rng = np.random.default_rng(5 + packed)
    m, k, n = 12, 100, 48
    jb = _binary_qt(rng, n, k)
    if packed:
        jb = jq.pack_binary_weight(jb)
    jb = jqt.with_grad_shadow(jb)
    x = (rng.standard_normal((3, m // 3, k)) * 0.8).astype(np.float32)
    sa, ba = np.float32(0.9), (rng.standard_normal(k) * 0.1).astype(np.float32)
    g = rng.standard_normal((3, m // 3, n)).astype(np.float32)

    @jax.jit
    def jvjp(x, qt, sa, ba, g):
        return jax.vjp(jbinary_linear, x, qt, sa, ba)[1](g)

    jgx, jgqt, jgsa, jgba = jvjp(jnp.asarray(x), jb, jnp.asarray(sa), jnp.asarray(ba), jnp.asarray(g))
    shadow = torch.nn.Parameter(torch.zeros(jb.logical_shape))
    tx, tsa, tba = _t(x, True), _t(sa, True), _t(ba, True)
    binary_linear(tx, _port_binary(jb, shadow), tsa, tba).backward(_t(g))
    _close(tx.grad, jgx, "grad_input")
    _close(tsa.grad, jgsa, "grad_scale_a")
    _close(tba.grad, jgba, "grad_bias_a")
    _codes_close(shadow.grad, jgqt.grad_shadow)
    assert np.abs(np.asarray(jgqt.grad_shadow)).max() == 127


@pytest.mark.parametrize("w_bit", [4, 8])
def test_qat_linear_forward_and_backward_match_jax(w_bit):
    rng = np.random.default_rng(w_bit)
    m, k, n = 10, 96, 40
    jw = jq.init_nbit_weight(jnp.asarray(rng.standard_normal((n, k)).astype(np.float32) * 0.05),
                             w_bit)
    jw = jqt.with_grad_shadow(jw)
    x = rng.standard_normal((2, m // 2, k)).astype(np.float32)
    sa = np.float32(0.21 if w_bit == 4 else 0.09)
    g = rng.standard_normal((2, m // 2, n)).astype(np.float32)

    @jax.jit
    def jfwd_vjp(x, qt, sa, g):
        out, vjp = jax.vjp(jqat_linear, x, qt, sa)
        return out, vjp(g)

    jout, (jgx, jgqt, jgsa) = jfwd_vjp(jnp.asarray(x), jw, jnp.asarray(sa), jnp.asarray(g))
    shadow = torch.nn.Parameter(torch.zeros((n, k)))
    tw = tqt.IntQTensor(data=_t(jw.data), scale_w=_t(jw.scale_w), w_bit=w_bit, grad_shadow=shadow)
    tx, tsa = _t(x, True), _t(sa, True)
    out = qat_linear(tx, tw, tsa)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    out.backward(_t(g))
    _close(tx.grad, jgx, "grad_input")
    _close(tsa.grad, jgsa, "grad_scale_a")
    _close(shadow.grad, jgqt.grad_shadow, "grad_weight")


def test_int_matmul_is_exact_where_f32_is_not():
    """8-bit codes at K = 4096: the f32 product rounds, the port's int path
    (f64 on the CPU) is the exact int32 dot."""
    rng = np.random.default_rng(0)
    a = np.full((4, 4096), 127, np.int8)
    a[:, ::2] = -128
    a[1:] = rng.integers(-128, 128, (3, 4096))
    b = rng.integers(-127, 128, (6, 4096)).astype(np.int8)
    b[0] = -127
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = int_matmul(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _conv_case(rng, bits, c=8, o=16):
    w = (rng.standard_normal((3, 3, c, o)) * 0.1).astype(np.float32)
    flat = w.reshape(-1, o).T
    if bits == 1:
        q = jq.init_binary_weight(jnp.asarray(flat))
        jqt_ = jqt.BinaryQTensor(data=q.data.T.reshape(3, 3, c, o), scale_w=q.scale_w)
    else:
        q = jq.init_nbit_weight(jnp.asarray(flat), bits)
        jqt_ = jqt.IntQTensor(data=q.data.T.reshape(3, 3, c, o), scale_w=q.scale_w, w_bit=bits)
    return jqt_.replace(grad_shadow=jnp.zeros(jqt_.data.shape, jnp.float32))


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("strides,padding", [((1, 1), "SAME"), ((2, 2), "SAME"), ((1, 1), "VALID")])
def test_quant_conv_matches_jax(bits, strides, padding):
    rng = np.random.default_rng(bits)
    jw = _conv_case(rng, bits)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    sa = np.float32(0.6 if bits == 1 else 0.3)
    jop = jconv.binary_conv2d if bits == 1 else jconv.qat_conv2d
    top = tconv.binary_conv2d if bits == 1 else tconv.qat_conv2d

    def jf(x, qt, sa):
        return jop(x, qt, sa, strides, padding)

    jout, vjp = jax.vjp(jf, jnp.asarray(x), jw, jnp.asarray(sa))
    g = rng.standard_normal(jout.shape).astype(np.float32)
    jgx, jgqt, jgsa = vjp(jnp.asarray(g))
    shadow = torch.nn.Parameter(torch.zeros(jw.data.shape))
    if bits == 1:
        tw = tqt.BinaryQTensor(data=_t(jw.data), scale_w=_t(jw.scale_w), grad_shadow=shadow)
    else:
        tw = tqt.IntQTensor(data=_t(jw.data), scale_w=_t(jw.scale_w), w_bit=bits, grad_shadow=shadow)
    tx, tsa = _t(x, True), _t(sa, True)
    out = top(tx, tw, tsa, strides, padding)
    assert tuple(out.shape) == jout.shape
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    out.backward(_t(g))
    _close(tx.grad, jgx, "grad_x")
    _close(tsa.grad, jgsa, "grad_scale_a")
    _close(shadow.grad, jgqt.grad_shadow, "grad_w")
