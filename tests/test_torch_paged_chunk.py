"""Kernel 6's read-only form on the tensor cores (``csrc/paged_attention.cu``
``paged_chunk_kernel``), modelled in plain torch on the CPU: 64-row query
tiles (rows past ``rs`` computed on zero q and dropped), 64-position key
tiles over the slot's valid prefix (positions past it zeroed and masked),
sweep 1 taking the row max over the whole window, sweep 2 recomputing the
same scores and forming ``p`` against that max, ``l`` on the unrounded
``p`` and ``bf16(p [* v_scale])`` times V added tile by tile.  The model is
held against the plain version and against the JAX package's
``_paged_kernel`` in interpret mode, as ``tests/test_torch_paged_attention.py``
runs it; the kernel's exact int8 -> bf16 conversion is checked bit for bit,
and the route is checked to send every read-only call to the new kernel.
The CUDA kernel runs only on the card (``chip_smoke.py`` phase 5a).
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

TILE = 64  # the kernel's query rows a block and positions a key tile
B, NKV, HD, PS, P = 3, 2, 128, 32, 6
RS = 4 * 25  # 4 query heads of a 25-token chunk: a partial second row tile
W = P * PS  # 192: three key tiles
PAGES = B * P + 1
# an empty slot, a length inside the second key tile (mid-page), and the
# whole window but its last position
CACHE_LEN = np.asarray([0, 70, W - 1], np.int32)
SM = 1.0 / math.sqrt(HD)


@functools.lru_cache(maxsize=None)
def _inputs(pool):
    rng = np.random.default_rng(10 if pool == "int8" else 11)
    q = rng.standard_normal((B, NKV, RS, HD)).astype(np.float32)
    q = np.asarray(torch.from_numpy(q).to(torch.bfloat16).float())
    shape = (PAGES, PS, NKV * HD)
    if pool == "int8":
        kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.03, (B, W + 8, NKV)).astype(np.float32) for _ in range(2))
    else:  # bf16 values, held as f32 for the JAX side
        kp, vp = (np.asarray(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                             .to(torch.bfloat16).float()) for _ in range(2))
        ks = vs = None
    table = (rng.permutation(PAGES - 1)[: B * P] + 1).reshape(B, P).astype(np.int32)
    return dict(q=q, kp=kp, vp=vp, ks=ks, vs=vs, table=table)


def _torch_args(a):
    t = {k: None if v is None else torch.from_numpy(v.copy()) for k, v in a.items()}
    t["q"] = t["q"].to(torch.bfloat16)
    if a["ks"] is None:  # bf16 pools
        t["kp"], t["vp"] = t["kp"].to(torch.bfloat16), t["vp"].to(torch.bfloat16)
    return t


def chunk_model(q, kp, vp, ks, vs, table, cache_len, sm_scale):
    """The chunk kernel's arithmetic, tile by tile; returns ``(acc, m, l)``."""
    b, nkv, rs, hd = q.shape
    ps, P = kp.shape[1], table.shape[1]
    dt = q.dtype
    n_rt = -(-rs // TILE)
    qp = torch.zeros(b, nkv, n_rt * TILE, hd)
    qp[:, :, :rs] = q.float()  # rows past rs: zero q, never stored
    kg = kp[table.long()].reshape(b, P * ps, nkv, hd)
    vg = vp[table.long()].reshape(b, P * ps, nkv, hd)
    acc = torch.zeros(b, nkv, n_rt * TILE, hd)
    m = torch.full((b, nkv, n_rt * TILE, 1), tpa.MASK)
    l = torch.zeros(b, nkv, n_rt * TILE, 1)
    for t in range(b):
        nv = min(max(int(cache_len[t]), 0), P * ps)
        n_tiles = -(-nv // TILE)

        def scores(j0):
            """The tile's scores, masked past the valid prefix (its rows
            there are zero in the ring), and its column validity."""
            j = torch.arange(j0, j0 + TILE)
            ok = j < nv
            jj = torch.where(ok, j, 0)
            k = torch.where(ok[:, None, None], kg[t, jj].to(dt).float(), 0.0)
            s = torch.einsum("grd,kgd->grk", qp[t], k) * sm_scale
            if ks is not None:
                s = s * torch.where(ok[:, None], ks[t, jj], 0.0).T[:, None, :]
            return torch.where(ok, s, tpa.MASK), ok, jj

        for i in range(n_tiles):  # sweep 1: the window's max
            s, _, _ = scores(i * TILE)
            m[t] = torch.maximum(m[t], s.amax(-1, keepdim=True))
        for i in range(n_tiles):  # sweep 2: p against it, l, P V
            s, ok, jj = scores(i * TILE)
            p = torch.where(ok, torch.exp(s - m[t]), 0.0)
            l[t] += p.sum(-1, keepdim=True)
            if vs is not None:
                p = p * torch.where(ok[:, None], vs[t, jj], 0.0).T[:, None, :]
            v = torch.where(ok[:, None, None], vg[t, jj].to(dt).float(), 0.0)
            acc[t] += torch.einsum("grk,kgd->grd", p.to(dt).float(), v)
    return acc[:, :, :rs], m[:, :, :rs], l[:, :, :rs]


def _model(pool):
    t = _torch_args(_inputs(pool))
    out = chunk_model(t["q"], t["kp"], t["vp"], t["ks"], t["vs"], t["table"],
                      torch.from_numpy(CACHE_LEN), SM)
    return [o.numpy() for o in out]


@functools.lru_cache(maxsize=None)
def _jax(pool):
    a = _inputs(pool)
    pool_dt = jnp.int8 if pool == "int8" else jnp.bfloat16
    out = jpa.paged_prefix_attention(
        jnp.asarray(a["q"]).astype(jnp.bfloat16), jnp.asarray(a["kp"]).astype(pool_dt),
        jnp.asarray(a["vp"]).astype(pool_dt),
        None if a["ks"] is None else jnp.asarray(a["ks"]),
        None if a["vs"] is None else jnp.asarray(a["vs"]),
        jnp.asarray(a["table"]), jnp.asarray(CACHE_LEN), sm_scale=SM, interpret=True)
    return [np.asarray(o.astype(jnp.float32)) for o in out]


def _check_empty(acc, m, l):
    # slot 0 has no cached position: m is the mask value, l and acc are 0
    assert (m[0] == np.float32(tpa.MASK)).all() and (l[0] == 0).all() and (acc[0] == 0).all()


@pytest.mark.parametrize("pool", ["int8", "bf16"])
def test_chunk_model_matches_plain(pool):
    """The tiles change only the f32 order of the dots, of l and of acc:
    the window's max is the same max, and p rounds against it."""
    acc, m, l = _model(pool)
    t = _torch_args(_inputs(pool))
    want = tpa.paged_prefix_attention_ref(t["q"], t["kp"], t["vp"], t["ks"], t["vs"], t["table"],
                                          torch.from_numpy(CACHE_LEN), SM)
    wacc, wm, wl = (w.numpy() for w in want)
    np.testing.assert_allclose(m, wm, rtol=1e-6)
    np.testing.assert_allclose(l, wl, rtol=1e-6)
    np.testing.assert_allclose(acc, wacc, rtol=1e-5, atol=1e-5 * np.abs(wacc).max())
    _check_empty(acc, m, l)


@pytest.mark.parametrize("pool", ["int8", "bf16"])
def test_chunk_model_matches_pallas(pool):
    """Against the interpret-mode JAX kernel at bf16 queries, at the
    tolerances of ``test_torch_paged_attention.py``'s bf16 case (a p on a
    rounding boundary may round the other way)."""
    acc, m, l = _model(pool)
    wacc, wm, wl = _jax(pool)
    np.testing.assert_allclose(m, wm[..., :1], rtol=1e-5)
    np.testing.assert_allclose(l, wl[..., :1], rtol=1e-5)
    np.testing.assert_allclose(acc, wacc, rtol=1e-2, atol=1e-2 * np.abs(wacc).max())
    _check_empty(acc, m, l)


def test_int8_to_bf16_conversion_is_exact():
    """``i8x4_to_bf16x4``: byte x, xored with 0x80, as the low bits of
    2^23 in f32, less 2^23 + 128, and the upper half of the result are the
    bf16 bits of x, for every int8 value."""
    x = np.arange(-128, 128, dtype=np.int32)
    u = (x.astype(np.uint32) & 0xFF) ^ 0x80
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    got = (f.view(np.uint32) >> 16).astype(np.uint16)
    want = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want.view(np.uint16))
    assert (f.view(np.uint32) & 0xFFFF == 0).all()


@pytest.mark.parametrize("b,rs,P", [
    (8, 4 * 256, 4),     # the serving run's chunk: b8, 256 tokens, window 256
    (8, 4 * 256, 16),    # a later chunk, window 1024
    (8, 4 * 100, 8),     # a short last chunk
    (8, 4, 8),           # 4 rows, as decode has them
    (8, 4, 1024),        # a window the row-tiled kernel refuses (shared memory)
    (2, 8 * 512, 2048),  # 8 query heads a KV head over a 128K window
])
def test_read_only_calls_take_the_chunk_kernel(b, rs, P):
    """Every read-only call takes paged_chunk_kernel, whatever its rows
    and window: it keeps no score slab, so no window is too long."""
    assert tpa.kernel_route(b, 8, rs, HD, P, 64, writeback=False) == "paged_chunk_kernel"


@pytest.mark.parametrize("b,nkv,rs,P,want", [
    (8, 8, 4, 8, "paged_decode_kernel"),       # Llama-3-8B decode at b8, window 512
    (64, 8, 4, 4, "paged_decode_kernel"),      # b64, window 256
    (33, 8, 4, 128, "paged_decode_kernel"),    # a full card at an 8K context
    (8, 8, 8, 512, "paged_attention_kernel"),  # 8 rows over 32K positions
    (8, 8, 4 * 256, 4, "paged_attention_kernel"),  # more rows than the decode kernel takes
])
def test_write_back_calls_keep_their_route(b, nkv, rs, P, want):
    """The write-back form keeps ``decode_plan``'s routes."""
    assert tpa.kernel_route(b, nkv, rs, HD, P, 64, writeback=True) == want
    assert (tpa.decode_plan(b, nkv, rs, HD, P, 64) is not None) == (want == "paged_decode_kernel")
