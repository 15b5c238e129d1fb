"""The backward of the port's quantized linears against the JAX package's
``custom_vjp`` (``jax.vjp`` with ``with_grad_shadow``) on the CPU, f32:
``grad_input`` and the grad shadow's cotangent ``xᵀ g`` of ``mpq_linear``
(w 2/4/8, sym and asym, with and without ``q_perm``) and of
``mbwq_linear`` (with and without ``channel_scale``, row- and
block-permuted).  rtol 1e-5, with an absolute floor of 1e-5 of the largest
value: both sides sum in f32, in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu import qtensor as jqtensor
from bitorch_engine_tpu.ops import mbwq_linear as jmb
from bitorch_engine_tpu.ops import mpq_linear as jlin
from bitorch_engine_tpu.ops import quant as jq
from bitorch_engine_tpu_torch.layers.linear import MPQLinear
from bitorch_engine_tpu_torch.ops import mbwq_linear as tmb
from bitorch_engine_tpu_torch.ops import mpq_linear as tlin
from bitorch_engine_tpu_torch.qtensor import with_grad_shadow, without_grad_shadow
from bitorch_engine_tpu_torch.utils.convert import _mbwq, _mpq


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _np_tree(jqt):
    return jax.tree_util.tree_map(np.asarray, jqt)


def _jax_grads(fn, x, jqt, g):
    _, vjp = jax.vjp(fn, jnp.asarray(x), jqtensor.with_grad_shadow(jqt))
    gx, gqt = vjp(jnp.asarray(g))
    return np.asarray(gx), np.asarray(gqt.grad_shadow)


def _port_grads(fn, x, tqt, g):
    tqt = with_grad_shadow(tqt)
    tqt.grad_shadow.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    fn(tx, tqt).backward(torch.from_numpy(g))
    return tx.grad.numpy(), tqt.grad_shadow.grad.numpy()


@pytest.mark.parametrize(
    "w_bit,asym,perm",
    [(2, False, False), (4, False, False), (8, False, False), (2, True, False),
     (4, True, False), (8, True, False), (4, False, True), (2, True, True)],
)
def test_mpq_backward_matches_jax(w_bit, asym, perm):
    rng = np.random.default_rng(w_bit * 10 + asym * 2 + perm)
    k, n, m = 256, 96, 24
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    jqt = jq.quantize_mpq(jnp.asarray(w), w_bit=w_bit, group_size=64, asym=asym)
    if perm:
        jqt = jqt.replace(q_perm=jnp.asarray(rng.permutation(k).astype(np.int32)))
    x = rng.standard_normal((2, m // 2, k)).astype(np.float32)
    g = rng.standard_normal((2, m // 2, n)).astype(np.float32)
    want_x, want_w = _jax_grads(jlin.mpq_linear, x, jqt, g)
    got_x, got_w = _port_grads(tlin.mpq_linear, x, _mpq(_np_tree(jqt), "cpu"), g)
    _close(got_x, want_x)
    _close(got_w, want_w)


@pytest.mark.parametrize("channel_scale,strategy", [
    (False, {"bits": [4, 2], "bits_prop": [0.75, 0.25], "group_size": {"4": 32, "2": 32}}),
    (True, {"bits": [4, 2], "bits_prop": [0.25, 0.75], "group_size": {"4": 64, "2": 128}}),
    (True, {"bits": [8, 4, 2], "bits_prop": [0.25, 0.5, 0.25],
            "group_size": {"8": 64, "4": 64, "2": 64}}),
])
def test_mbwq_backward_matches_jax(channel_scale, strategy):
    rng = np.random.default_rng(len(strategy["bits"]) + channel_scale)
    k, n = 512, 64
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    cs = jnp.asarray(rng.uniform(0.5, 1.5, k).astype(np.float32)) if channel_scale else None
    jqt = jmb.quantize_mbwq(jnp.asarray(w), strategy, channel_scale=cs)
    x = rng.standard_normal((3, 5, k)).astype(np.float32)
    g = rng.standard_normal((3, 5, n)).astype(np.float32)
    want_x, want_w = _jax_grads(jmb.mbwq_linear, x, jqt, g)
    got_x, got_w = _port_grads(tmb.mbwq_linear, x, _mbwq(_np_tree(jqt), "cpu"), g)
    _close(got_x, want_x)
    _close(got_w, want_w)


def test_row_gather_backward_matches_block_gather():
    """A permutation applied row by row (``perm_block`` 0) gives the
    gradients of the block-structured gather."""
    rng = np.random.default_rng(7)
    strategy = {"bits": [4, 2], "bits_prop": [0.5, 0.5], "group_size": {"4": 32, "2": 32}}
    tqt = tmb.quantize_mbwq(torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32)),
                            strategy)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    g = rng.standard_normal((4, 32)).astype(np.float32)
    block = _port_grads(tmb.mbwq_linear, x, tqt, g)
    rows = _port_grads(tmb.mbwq_linear, x, tqt.replace(perm_block=0, block_perm=None), g)
    for a, b in zip(block, rows):
        np.testing.assert_array_equal(a, b)


def test_layer_shadow_parameter_receives_the_weight_gradient():
    """An ``MPQLinear`` in training mode: its grad shadow is an f32
    ``nn.Parameter`` of the logical shape whose ``.grad`` is ``xᵀ g``; the
    bias gets its gradient; without the shadow no weight gradient is made."""
    gen = torch.Generator().manual_seed(0)
    layer = MPQLinear(128, 48, use_bias=True, dtype=torch.float32, device="cpu", generator=gen)
    layer.set_qweight(with_grad_shadow(layer.qweight))
    layer.bias.requires_grad_()
    assert isinstance(layer.grad_shadow, torch.nn.Parameter)
    assert layer.grad_shadow.shape == (128, 48) and layer.grad_shadow.dtype == torch.float32
    x = torch.randn(6, 128, generator=gen)
    g = torch.randn(6, 48, generator=gen)
    layer(x).backward(g)
    torch.testing.assert_close(layer.grad_shadow.grad, x.T @ g, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(layer.bias.grad, g.sum(0))
    layer.set_qweight(without_grad_shadow(layer.qweight))
    layer.bias.requires_grad_(False)
    assert layer.grad_shadow is None and "grad_shadow" not in dict(layer.named_parameters())
    assert not layer(x).requires_grad
