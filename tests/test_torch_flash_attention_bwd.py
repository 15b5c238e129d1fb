"""Kernel 4's plain version and the differentiable flash attention against
the JAX package's flash attention, differentiated by ``jax.vjp`` with its
Pallas kernels in interpret mode, at the shapes of its own gradient test
(GQA rep 2, MHA d 64, non-causal rep 4), f32.  Tolerances: those of the
JAX package's test (atol 2e-5, rtol 1e-4): both sides sum in f32, in
another order.  A bf16 case holds the plain version's rounding points
against the JAX package's backward kernels.  The CUDA kernels run only on
the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops.pallas import flash_attention as jax_fa
from bitorch_engine_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from bitorch_engine_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_diff,
)

SHAPES = [  # b, nh, nkv, s, d, causal
    (2, 4, 2, 256, 128, True),
    (1, 4, 4, 128, 64, True),
    (1, 8, 2, 256, 128, False),
]


def _inputs(b, nh, nkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, nh, s, d), (b, nkv, s, d), (b, nkv, s, d), (b, nh, s, d))]


@pytest.mark.parametrize("b,nh,nkv,s,d,causal", SHAPES)
def test_backward_matches_jax_vjp(b, nh, nkv, s, d, causal):
    """``flash_attention_bwd_ref`` and the autograd Function's gradients
    against ``jax.vjp`` of the JAX flash attention (interpret mode)."""
    q, k, v, do = _inputs(b, nh, nkv, s, d, seed=s + d + nh)
    out_j, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash(q_, k_, v_, causal=causal, interpret=True, block_q=128),
        *(jnp.asarray(a) for a in (q, k, v)),
    )
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_diff(tq, tk, tv, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=2e-5, rtol=1e-4)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    o, lse = flash_attention(tq.detach(), tk.detach(), tv.detach(), causal)
    plain = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), o, lse,
                                    torch.from_numpy(do), causal)
    for name, g, p, w in zip("qkv", got, plain, want):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5, rtol=1e-4, err_msg=f"d{name}")
        assert torch.equal(g, p), f"d{name}: the Function's backward is not the plain version"


@pytest.mark.parametrize("b,nh,nkv,s,d,causal", [(1, 4, 2, 128, 64, True), (1, 4, 1, 128, 128, False)])
def test_bf16_backward_rounds_where_jax_rounds(b, nh, nkv, s, d, causal):
    """bf16, as the training path runs: ``flash_attention_bwd_ref`` against
    the JAX package's backward kernels (interpret mode) on the same
    residuals (its forward's out and lse).  Both round ``p`` before the dv
    product and ``ds`` before the dq / dk products, so only f32 summation
    order differs, which moves a few elements by one bf16 step: at most 1%
    of the elements differ (they read 0.01-0.3%) and max|d|/max|ref| <= 4e-3
    (one bf16 step of the largest).  A cast left out or added makes ~40% of
    the elements differ."""
    q, k, v, do = _inputs(b, nh, nkv, s, d, seed=7 + d)
    scale = d ** -0.5

    def lanes(a):  # the JAX wrapper's layout: (b*heads, s, d zero-padded to 128)
        a = jnp.asarray(a, jnp.bfloat16)
        return jnp.pad(a, ((0, 0), (0, 0), (0, 0), (0, 128 - d))).reshape(-1, s, 128)

    jq, jk, jv, jdo = (lanes(a) for a in (q, k, v, do))
    kw = dict(causal=causal, sm_scale=scale, bq=128, bk=128, interpret=True)
    out_j, lse_j = jax_fa._fwd_call(jq, jk, jv, **kw)
    want = [np.asarray(g[..., :d].astype(jnp.float32)) for g in jax_fa._bwd_call(
        jq, jk, jv, out_j, lse_j, jdo, **kw)]

    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    out = torch.from_numpy(np.asarray(out_j[..., :d].astype(jnp.float32))).reshape(q.shape)
    lse = torch.from_numpy(np.asarray(lse_j[..., 0])).reshape(b, nh, s)
    got = flash_attention_bwd_ref(tq, tk, tv, out.to(torch.bfloat16), lse, tdo, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy().reshape(w.shape)
        rel = np.abs(g - w).max() / np.abs(w).max()
        differing = np.mean(g != w)
        assert rel <= 4e-3 and differing <= 1e-2, (f"d{name}", rel, differing)


@pytest.mark.parametrize("b,nh,nkv,s,d,causal", [(1, 4, 2, 256, 64, True), (1, 4, 1, 256, 64, False)])
def test_bf16_backward_of_the_ports_own_forward(b, nh, nkv, s, d, causal):
    """End to end in bf16: the plain backward fed the port's own forward
    (``flash_attention_ref`` at the model's tile rule) against the JAX
    backward kernels fed the JAX forward's residuals (interpret mode, the
    tile ``_pick_block(s)`` as the model's calls take it).  With ``p``
    rounded where the JAX forward rounds it, out and lse agree but for f32
    summation order, so dq, dk and dv meet the bar of
    ``test_bf16_backward_rounds_where_jax_rounds``: at most 1% of the
    elements differ and max|d|/max|ref| <= 4e-3 (with ``p`` left unrounded
    in the forward, ~30% of dq and dk differ)."""
    q, k, v, do = _inputs(b, nh, nkv, s, d, seed=17 + d)
    scale = d ** -0.5
    block = jax_fa._pick_block(s)

    def lanes(a):
        a = jnp.asarray(a, jnp.bfloat16)
        return jnp.pad(a, ((0, 0), (0, 0), (0, 0), (0, 128 - d))).reshape(-1, s, 128)

    jq, jk, jv, jdo = (lanes(a) for a in (q, k, v, do))
    kw = dict(causal=causal, sm_scale=scale, bq=block, bk=block, interpret=True)
    out_j, lse_j = jax_fa._fwd_call(jq, jk, jv, **kw)
    want = [np.asarray(g[..., :d].astype(jnp.float32)) for g in jax_fa._bwd_call(
        jq, jk, jv, out_j, lse_j, jdo, **kw)]

    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    out, lse = flash_attention(tq, tk, tv, causal, scale)
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, scale)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy().reshape(w.shape)
        rel = np.abs(g - w).max() / np.abs(w).max()
        differing = np.mean(g != w)
        assert rel <= 4e-3 and differing <= 1e-2, (f"d{name}", rel, differing)


def test_gqa_dk_dv_sum_the_query_heads():
    """dk / dv of a GQA group equal the sums, over the group's query heads,
    of the MHA gradients with K / V repeated per query head."""
    b, nh, nkv, s, d = 1, 8, 2, 128, 32
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(b, nh, nkv, s, d, seed=3))
    rep = nh // nkv
    kr, vr = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    o, lse = flash_attention(q, k, v)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do)
    o_r, lse_r = flash_attention(q, kr, vr)
    dq_r, dk_r, dv_r = flash_attention_bwd_ref(q, kr, vr, o_r, lse_r, do)
    torch.testing.assert_close(dq, dq_r, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(dk, dk_r.reshape(b, nkv, rep, s, d).sum(2), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dv, dv_r.reshape(b, nkv, rep, s, d).sum(2), atol=1e-5, rtol=1e-5)


def test_backward_wrapper_on_cpu_is_the_plain_version():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 128, 64, seed=5))
    o, lse = flash_attention(q, k, v, causal=False, sm_scale=0.2)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=False, sm_scale=0.2)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False, sm_scale=0.2)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    assert flash_attention_bwd.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd(*(t.to("meta") for t in (q, k, v, o)), lse.to("meta"), do.to("meta"))
