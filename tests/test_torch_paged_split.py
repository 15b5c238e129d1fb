"""Kernel 6's write-back decode form split over a cluster
(``csrc/paged_attention.cu`` ``paged_decode_kernel``), modelled in plain
torch on the CPU: each rank takes a contiguous share of a slot's valid pages
and its rows' local max, the window's max is the max of the ranks' maxes,
``p`` is rounded to the working dtype against that max (not against a
rank's own, which would drift from the reference), and the ranks' ``l`` and
PV parts are added in rank order.  The model is held against the plain
version ``paged_prefix_attention_update_ref`` and against the JAX package's
``_paged_kernel`` in interpret mode, as ``tests/test_torch_paged_attention.py``
runs it.  The CUDA kernel runs only on the card (``chip_smoke.py`` phase 5a).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a test process)
from bitorch_engine_tpu.ops.pallas import paged_attention as jpa
from bitorch_engine_tpu_torch.ops.cuda import paged_attention as tpa

B, NKV, RS, HD, PAGES, PS, P = 3, 2, 4, 128, 32, 8, 8
W = P * PS
# an empty slot, a length that ends mid-page, the whole window but the
# position being written
CACHE_LEN = np.asarray([0, 13, W - 1], np.int32)
SM = 1.0 / math.sqrt(HD)


@functools.lru_cache(maxsize=None)
def _inputs(pool):
    rng = np.random.default_rng(0 if pool == "int8" else 1)
    q = rng.standard_normal((B, NKV, RS, HD)).astype(np.float32)
    q = np.asarray(torch.from_numpy(q).to(torch.bfloat16).float())
    shape = (PAGES, PS, NKV * HD)
    if pool == "int8":
        kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.03, (B, W + 8, NKV)).astype(np.float32) for _ in range(2))
        kn, vn = (rng.integers(-127, 128, (B, NKV * HD)).astype(np.int8) for _ in range(2))
    else:  # bf16 values, held as f32 for the JAX side
        kp, vp, kn, vn = (
            np.asarray(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                       .to(torch.bfloat16).float())
            for s in (shape, shape, (B, NKV * HD), (B, NKV * HD)))
        ks = vs = None
    table = (rng.permutation(PAGES - 1)[: B * P] + 1).reshape(B, P).astype(np.int32)
    return dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs, table=table, kn=kn, vn=vn)


def _torch_args(a):
    t = {k: None if v is None else torch.from_numpy(v.copy()) for k, v in a.items()}
    if a["ks"] is None:  # bf16 pools
        for k in ("kp", "vp", "kn", "vn"):
            t[k] = t[k].to(torch.bfloat16)
    return t


def split_model(q, kp, vp, ks, vs, table, cache_len, kn, vn, sm_scale, n_split):
    """The decode kernel's arithmetic over a cluster of ``n_split`` ranks,
    then its write of the new token; returns ``(acc, m, l)``."""
    b, nkv, rs, hd = q.shape
    ps, P = kp.shape[1], table.shape[1]
    dt = q.dtype
    kg = kp[table.long()].reshape(b, P * ps, nkv, hd)
    vg = vp[table.long()].reshape(b, P * ps, nkv, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", q.float(), kg.to(dt).float()) * sm_scale
    if ks is not None:
        s = s * ks[:, : P * ps].permute(0, 2, 1)[:, :, None, :]
    acc = torch.zeros(b, nkv, rs, hd)
    m = torch.full((b, nkv, rs, 1), tpa.MASK)
    l = torch.zeros(b, nkv, rs, 1)
    for t in range(b):
        nv = min(int(cache_len[t]), P * ps)
        nvp = -(-nv // ps)
        spans = [(r * nvp // n_split * ps, min((r + 1) * nvp // n_split * ps, nv))
                 for r in range(n_split)]
        maxes = [s[t, ..., lo:hi].amax(-1, keepdim=True) if hi > lo
                 else torch.full((nkv, rs, 1), tpa.MASK) for lo, hi in spans]
        mt = torch.stack(maxes).amax(0)  # the window's max
        for lo, hi in spans:  # rank order
            p = torch.exp(s[t, ..., lo:hi] - mt)
            l[t] += p.sum(-1, keepdim=True)
            if vs is not None:
                p = p * vs[t, lo:hi].T[:, None, :]
            acc[t] += torch.einsum("grk,kgd->grd", p.to(dt).float(), vg[t, lo:hi].to(dt).float())
        m[t] = mt
    clen = torch.as_tensor(cache_len).long()
    wp = torch.clamp(clen // ps, max=P - 1)
    pages = table.long()[torch.arange(b), wp]
    for pool, new in ((kp, kn), (vp, vn)):
        pool[pages, clen % ps] = new.to(pool.dtype)
    return acc, m, l


def _model(a, n_split):
    t = _torch_args(a)
    out = split_model(t["q"].to(torch.bfloat16), t["kp"], t["vp"], t["ks"], t["vs"], t["table"],
                      torch.from_numpy(CACHE_LEN), t["kn"], t["vn"], SM, n_split)
    return [o.numpy() for o in out], t


@functools.lru_cache(maxsize=None)
def _jax(pool):
    a = _inputs(pool)
    pool_dt = jnp.int8 if pool == "int8" else jnp.bfloat16
    args = [jnp.asarray(a["q"]).astype(jnp.bfloat16), jnp.asarray(a["kp"]).astype(pool_dt),
            jnp.asarray(a["vp"]).astype(pool_dt),
            None if a["ks"] is None else jnp.asarray(a["ks"]),
            None if a["vs"] is None else jnp.asarray(a["vs"]),
            jnp.asarray(a["table"]), jnp.asarray(CACHE_LEN)]
    out = jpa.paged_prefix_attention_update(
        *args, jnp.asarray(a["kn"]).astype(pool_dt), jnp.asarray(a["vn"]).astype(pool_dt),
        sm_scale=SM, interpret=True)
    return [np.asarray(o.astype(jnp.float32)) for o in out]


def _check_empty(acc, m, l):
    # slot 0 has no cached position: m is the mask value, l and acc are 0
    assert (m[0] == np.float32(tpa.MASK)).all() and (l[0] == 0).all() and (acc[0] == 0).all()


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
@pytest.mark.parametrize("pool", ["int8", "bf16"])
def test_split_model_matches_ref(pool, n_split):
    """Only the f32 order of l and acc differs from the plain version: the
    scores, the window's max and the rounded p are the same values."""
    a = _inputs(pool)
    (acc, m, l), t = _model(a, n_split)
    r = _torch_args(a)
    want = tpa.paged_prefix_attention_update_ref(
        r["q"].to(torch.bfloat16), r["kp"], r["vp"], r["ks"], r["vs"], r["table"],
        torch.from_numpy(CACHE_LEN), r["kn"], r["vn"], SM)
    wacc, wm, wl = (w.numpy() for w in want)
    np.testing.assert_array_equal(m, wm)
    np.testing.assert_allclose(l, wl, rtol=1e-6)
    np.testing.assert_allclose(acc, wacc, rtol=1e-5, atol=1e-6 * np.abs(wacc).max())
    _check_empty(acc, m, l)
    assert torch.equal(t["kp"], r["kp"]) and torch.equal(t["vp"], r["vp"])


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
@pytest.mark.parametrize("pool", ["int8", "bf16"])
def test_split_model_matches_pallas(pool, n_split):
    """Against the interpret-mode JAX kernel at bf16 queries, at the
    tolerances of ``test_torch_paged_attention.py``'s bf16 case (a p on a
    rounding boundary may round the other way), and the pools bit-equal
    after the write."""
    a = _inputs(pool)
    (acc, m, l), t = _model(a, n_split)
    wacc, wm, wl, wkp, wvp = _jax(pool)
    np.testing.assert_allclose(m, wm[..., :1], rtol=1e-5)
    np.testing.assert_allclose(l, wl[..., :1], rtol=1e-5)
    np.testing.assert_allclose(acc, wacc, rtol=1e-2, atol=1e-2 * np.abs(wacc).max())
    _check_empty(acc, m, l)
    np.testing.assert_array_equal(t["kp"].float().numpy(), wkp)
    np.testing.assert_array_equal(t["vp"].float().numpy(), wvp)


@pytest.mark.parametrize("b,nkv,P,want", [
    (8, 8, 8, 4),     # Llama-3-8B at b8, window 512 (pages of 64)
    (8, 8, 4, 4),     # window 256
    (8, 8, 16, 4),    # window 1024
    (8, 8, 2, 2),     # no more ranks than pages
    (16, 8, 8, 2),
    (32, 8, 8, 1),
    (64, 8, 4, 1),    # b64: 512 blocks already fill the card
    (1, 8, 2, 2),
])
def test_window_splits(b, nkv, P, want):
    assert tpa.window_splits(b, nkv, P, sms=132) == want


@pytest.mark.parametrize("b,nkv,rs,P,want", [
    (8, 8, 4, 8, (4, 4)),       # Llama-3-8B at b8, window 512 (pages of 64)
    (64, 8, 4, 4, (4, 1)),      # b64, window 256: the card is full at S = 1
    (34, 4, 7, 64, (8, 2)),     # Qwen2-7B, full card, its 4096 context: S = 1 overflows
    (33, 8, 4, 128, (4, 2)),    # Llama-3-8B, full card, an 8K context
    (8, 8, 8, 512, None),       # 8 rows over 32K positions: no cluster of <= 4 fits
    (8, 8, 4 * 256, 4, None),   # the chunk form's rows
])
def test_decode_plan(b, nkv, rs, P, want):
    """The write-back route is chosen from the shape: the decode kernel at
    a cluster size whose share of the window fits shared memory, else the
    row-tiled kernel, which then fits the window itself."""
    got = tpa.decode_plan(b, nkv, rs, HD, P, 64, sms=132)
    assert got == want
    if got is None:
        r = tpa._rows_per_tile(rs, HD, P, 64)
        assert tpa._smem_bytes(r, HD, P, 64) <= tpa._SMEM_LIMIT
    else:
        assert tpa._decode_smem_bytes(got[0], HD, P, 64, got[1]) <= tpa._SMEM_LIMIT
