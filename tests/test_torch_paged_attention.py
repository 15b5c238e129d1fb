"""Kernel 6's plain versions against the JAX package's paged-attention
kernel in interpret mode, as ``tests/test_paged_attention_kernel.py`` runs
it: random page tables, per-slot cache lengths 0, mid and W - 1, int8 pools
with dense per-slot scales and f32 pools.  The CUDA kernel runs only on the
card (``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops.pallas import paged_attention as jpa
from bitorch_engine_tpu_torch.ops.cuda import paged_attention as tpa

B, NKV, RS, HD, PAGES, PS, P = 3, 2, 4, 128, 16, 8, 4
W = P * PS
CACHE_LEN = np.asarray([0, 13, W - 1], np.int32)
SM = 1.0 / math.sqrt(HD)


def _inputs(quant, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NKV, RS, HD)).astype(np.float32)
    shape = (PAGES, PS, NKV * HD)
    if quant:
        kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        # dense per-slot scales, longer than the window (the prefix is read)
        ks, vs = (rng.uniform(0.01, 0.03, (B, W + 8, NKV)).astype(np.float32) for _ in range(2))
        kn, vn = (rng.integers(-127, 128, (B, NKV * HD)).astype(np.int8) for _ in range(2))
    else:
        kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        ks = vs = None
        kn, vn = (rng.standard_normal((B, NKV * HD)).astype(np.float32) for _ in range(2))
    # distinct shuffled pages per slot; page 0 (null) never mapped
    table = (rng.permutation(PAGES - 1)[: B * P] + 1).reshape(B, P).astype(np.int32)
    return dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs, table=table, kn=kn, vn=vn)


def _jax(a, update, q_dtype=jnp.float32):
    args = [jnp.asarray(a["q"]).astype(q_dtype), jnp.asarray(a["kp"]), jnp.asarray(a["vp"]),
            None if a["ks"] is None else jnp.asarray(a["ks"]),
            None if a["vs"] is None else jnp.asarray(a["vs"]),
            jnp.asarray(a["table"]), jnp.asarray(CACHE_LEN)]
    if update:
        out = jpa.paged_prefix_attention_update(
            *args, jnp.asarray(a["kn"]), jnp.asarray(a["vn"]), sm_scale=SM, interpret=True)
    else:
        out = jpa.paged_prefix_attention(*args, sm_scale=SM, interpret=True)
    return [np.asarray(o.astype(jnp.float32)) if o.dtype == jnp.bfloat16 else np.asarray(o)
            for o in out]


def _torch(a, fn, q_dtype=torch.float32):
    t = {k: None if v is None else torch.from_numpy(v.copy()) for k, v in a.items()}
    args = [t["q"].to(q_dtype), t["kp"], t["vp"], t["ks"], t["vs"], t["table"],
            torch.from_numpy(CACHE_LEN)]
    if fn is tpa.paged_prefix_attention_update_ref:
        out = fn(*args, t["kn"], t["vn"], SM)
    else:
        out = fn(*args, SM)
    return [o.numpy() for o in out], t


def _check_state(got, want, rtol, atol):
    acc, m, l = got
    wacc, wm, wl = want
    np.testing.assert_allclose(m, wm[..., :1], rtol=1e-6, atol=0)
    np.testing.assert_allclose(l, wl[..., :1], rtol=rtol, atol=atol)
    np.testing.assert_allclose(acc, wacc, rtol=rtol, atol=atol * np.abs(wacc).max())
    # slot 0 has no cached position: m is the mask value, l and acc are 0
    assert (m[0] == np.float32(tpa.MASK)).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    # the context, where the JAX test compares it, at that test's tolerance
    valid = CACHE_LEN > 0
    np.testing.assert_allclose(acc[valid] / l[valid], wacc[valid] / wl[valid][..., :1],
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("quant", [True, False], ids=["int8_pools", "f32_pools"])
def test_plain_matches_pallas(quant):
    a = _inputs(quant, seed=0)
    got, _ = _torch(a, tpa.paged_prefix_attention_ref)
    _check_state(got, _jax(a, update=False), rtol=1e-5, atol=1e-6)


def test_plain_matches_pallas_bf16_queries():
    """bf16 working dtype: both round p to bf16 before the PV product; a
    p on a rounding boundary may round the other way (one bf16 ulp)."""
    a = _inputs(True, seed=1)
    got, _ = _torch(a, tpa.paged_prefix_attention_ref, torch.bfloat16)
    want = _jax(a, update=False, q_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got[1], want[1][..., :1], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2][..., :1], rtol=1e-5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-2, atol=1e-2 * np.abs(want[0]).max())


@pytest.mark.parametrize("quant", [True, False], ids=["int8_pools", "f32_pools"])
def test_update_plain_matches_pallas(quant):
    """The write-back variant: the same state, and pools bit-equal to the
    JAX kernel's after its in-place page write."""
    a = _inputs(quant, seed=2)
    got, t = _torch(a, tpa.paged_prefix_attention_update_ref)
    want = _jax(a, update=True)
    _check_state(got, want[:3], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t["kp"].numpy(), want[3])
    np.testing.assert_array_equal(t["vp"].numpy(), want[4])
    assert not np.array_equal(t["kp"].numpy(), a["kp"])  # the write happened


def test_merge_matches_jax():
    rng = np.random.default_rng(3)
    acc_p, acc_n = (rng.standard_normal((2, 2, 4, HD)).astype(np.float32) for _ in range(2))
    m_p, m_n = (rng.standard_normal((2, 2, 4, 1)).astype(np.float32) for _ in range(2))
    l_p, l_n = (rng.uniform(0.5, 3, (2, 2, 4, 1)).astype(np.float32) for _ in range(2))
    want = jpa.merge_attention_parts(*(jnp.asarray(x) for x in (acc_p, m_p, l_p, acc_n, m_n, l_n)))
    got = tpa.merge_attention_parts(*(torch.from_numpy(x) for x in (acc_p, m_p, l_p, acc_n, m_n, l_n)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # lane-broadcast stats of width hd give the same result
    wide = [torch.from_numpy(np.broadcast_to(x, (2, 2, 4, HD)).copy()) for x in (m_p, l_p)]
    got_wide = tpa.merge_attention_parts(torch.from_numpy(acc_p), *wide, torch.from_numpy(acc_n),
                                         torch.from_numpy(m_n), torch.from_numpy(l_n))
    np.testing.assert_allclose(got_wide.numpy(), got.numpy(), rtol=1e-6)


def test_wrappers_on_cpu_are_the_plain_versions():
    a = _inputs(True, seed=4)
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    args = (t["q"], t["kp"], t["vp"], t["ks"], t["vs"], t["table"], CACHE_LEN.tolist())
    got = tpa.paged_prefix_attention(*args, sm_scale=SM)
    want = tpa.paged_prefix_attention_ref(*args, SM)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    kp_ref, vp_ref = t["kp"].clone(), t["vp"].clone()
    tpa.paged_prefix_attention_update_ref(t["q"], kp_ref, vp_ref, *args[3:], t["kn"], t["vn"], SM)
    tpa.paged_prefix_attention_update(*args, t["kn"], t["vn"], sm_scale=SM)
    assert torch.equal(t["kp"], kp_ref) and torch.equal(t["vp"], vp_ref)
    assert tpa.paged_prefix_attention.launches == 0
    assert tpa.paged_prefix_attention_update.launches == 0


@pytest.mark.parametrize("rs,w,want", [(4, 1024, 4), (1024, 1024, 32), (1024, 2048, 16),
                                       (6, 512, 8), (1, 64, 1), (1024, 4096, 8)])
def test_row_tile_fits_shared_memory(rs, w, want):
    r = tpa._rows_per_tile(rs, 128, w // 64, 64)
    assert r == want and tpa._smem_bytes(r, 128, w // 64, 64) <= tpa._SMEM_LIMIT


def test_window_too_large_for_shared_memory_raises():
    with pytest.raises(ValueError, match="shared memory"):
        tpa._rows_per_tile(4, 128, 1024, 64)
