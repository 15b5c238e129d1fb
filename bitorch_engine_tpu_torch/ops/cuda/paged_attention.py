"""Kernel 6: paged prefix attention, read-only and with the in-place token
write.

The counterpart of ``bitorch_engine_tpu/ops/pallas/paged_attention.py``.
The kernels live in ``csrc/paged_attention.cu``; :func:`kernel_route`
picks one from the call's form and shape: every read-only call (the
chunked prefill's prefix) runs ``paged_chunk_kernel`` (kernel 3's two-sweep
``mma.sync`` body over the pages); the write-back form with at most
:data:`DECODE_MAX_ROWS` query rows (every decode step) runs
``paged_decode_kernel``, the window split over a cluster of blocks per (KV
head, slot), where :func:`decode_plan` finds a cluster size whose share of
the window fits the kernel's shared memory; the rest of the write-back form
``paged_attention_kernel``.  Each wrapper launches a kernel for CUDA
tensors, raises on what it does not take, and runs the plain version beside
it only for CPU tensors.  ``paged_prefix_attention.launches`` and
``paged_prefix_attention_update.launches`` count launches.

Both return the unnormalised streaming-softmax state ``(acc, m, l)`` of
``q`` over each slot's cached prefix: ``acc`` (b, nkv, rs, hd) f32 and the
row max ``m`` and sum ``l`` as (b, nkv, rs, 1) f32 (the TPU kernel's
128-lane broadcast is not kept; :func:`merge_attention_parts` takes either).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

# the reference's finite mask value: a slot with no valid position gives
# m = -1e30, l = 0, which the two-way merge zeroes out
MASK = -1e30
HEAD_DIMS = (128,)
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
_WARPS = 8  # warps per block in the kernels
DECODE_MAX_ROWS = 8  # query rows per KV head that paged_decode_kernel takes
_DEC_RING_BYTES = 32 * 1024  # paged_decode_kernel's ring

CacheLen = Union[int, Sequence[int], torch.Tensor]


@functools.lru_cache(maxsize=None)
def _fn():
    return _build.function(
        "paged_attention", "bte_paged_attention",
        [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    )


@functools.lru_cache(maxsize=None)
def _chunk_fn():
    return _build.function(
        "paged_attention", "bte_paged_chunk",
        [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    )


@functools.lru_cache(maxsize=None)
def _decode_fn():
    return _build.function(
        "paged_attention", "bte_paged_decode",
        [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    )


def window_splits(b: int, nkv: int, P: int, sms: int = 132) -> int:
    """Blocks of a cluster that share one (KV head, slot) of the decode
    kernel, each a contiguous share of the window's ``P`` pages: the largest
    of 4 and 2 whose ``b · nkv · S`` blocks fit two to an SM on the ``sms``
    SMs, else 1, and never more than ``P``.  Batch 8 of Llama-3-8B (8 KV
    heads) takes 4, batch 16 2, batch 32 and up 1.  On the card a cluster
    costs a few µs of launch and synchronisation that grow with its size
    (PERF.md §6), so 8 is never taken."""
    s = 1
    for cand in (4, 2):
        if b * nkv * cand <= 2 * sms:
            s = cand
            break
    while s > P:
        s //= 2
    return s


def decode_plan(b: int, nkv: int, rs: int, hd: int, P: int, ps: int,
                sms: int = 132) -> Optional[Tuple[int, int]]:
    """The write-back form's route, chosen from the shape: ``(R, S)`` for
    ``paged_decode_kernel`` (``R`` the ``rs`` query rows rounded up to a
    power of 2, ``S`` the cluster size of :func:`window_splits`, doubled up
    to 4 and ``P`` while a rank's share of the window does not fit shared
    memory), or None where ``rs`` exceeds :data:`DECODE_MAX_ROWS` or no
    such cluster fits, and ``paged_attention_kernel`` takes the call.  A
    full card with a long window (batch 34 of Qwen2-7B at 4096, batch 33 of
    Llama-3-8B at 8192) takes a cluster of 2; windows past about 16K
    positions at 8 rows (29K at 4) take the other kernel."""
    if rs > DECODE_MAX_ROWS:
        return None
    r = 1
    while r < rs:
        r *= 2
    s = window_splits(b, nkv, P, sms)
    while _decode_smem_bytes(r, hd, P, ps, s) > _SMEM_LIMIT:
        if 2 * s > min(4, P):
            return None
        s *= 2
    return r, s


def kernel_route(b: int, nkv: int, rs: int, hd: int, P: int, ps: int, writeback: bool,
                 sms: int = 132) -> str:
    """The kernel that takes a call, chosen from its form and shape:
    ``paged_chunk_kernel`` for every read-only call (any rows, any
    window); for the write-back form ``paged_decode_kernel`` where
    :func:`decode_plan` places it, else ``paged_attention_kernel``."""
    if not writeback:
        return "paged_chunk_kernel"
    if decode_plan(b, nkv, rs, hd, P, ps, sms) is not None:
        return "paged_decode_kernel"
    return "paged_attention_kernel"


def _decode_smem_bytes(r: int, hd: int, P: int, ps: int, n_split: int) -> int:
    """Shared memory of ``paged_decode_kernel`` (``dec_smem_bytes`` in the
    source): its ring, the rank's scores and scales, its warps' PV parts,
    its acc part, its m and l parts and the window's table row."""
    span = -(-P // n_split) * ps
    return _DEC_RING_BYTES + ((r + 2) * span + _WARPS * r * hd + r * hd + 2 * r) * 4 + P * 4


def cache_len_tensor(cache_len: CacheLen, b: int, device) -> torch.Tensor:
    """A cache length (int, per-slot sequence or tensor) as int32 (b,)."""
    t = torch.as_tensor(cache_len, device=device).to(torch.int32)
    return t.expand(b).contiguous() if t.dim() == 0 else t


def _gather(pool: torch.Tensor, table: torch.Tensor, nkv: int) -> torch.Tensor:
    """(pages, ps, nkv·hd) pool → (b, P·ps, nkv, hd) window view."""
    b, P = table.shape
    g = pool[table.long()]  # (b, P, ps, nkv·hd)
    return g.reshape(b, P * pool.shape[1], nkv, -1)


def _window_scale(cache: torch.Tensor, W: int) -> torch.Tensor:
    """Dense (slots, L, nkv) scales → (b, nkv, 1, W)."""
    return cache[:, :W].permute(0, 2, 1)[:, :, None, :]


def paged_prefix_attention_ref(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
    page_table: torch.Tensor, cache_len: CacheLen, sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: gather the window's pages and compute the reference's
    math in f32 (codes cast to ``q.dtype`` in the dots, scales factored out,
    ``p`` rounded to ``q.dtype`` before the PV product)."""
    b, nkv, rs, hd = q.shape
    W = page_table.shape[1] * k_pool.shape[1]
    dt = q.dtype
    kg = _gather(k_pool, page_table, nkv)
    vg = _gather(v_pool, page_table, nkv)
    s = torch.einsum("bgrd,bkgd->bgrk", q.float(), kg.to(dt).float()) * sm_scale
    if k_scale is not None:
        s = s * _window_scale(k_scale, W)
    clen = cache_len_tensor(cache_len, b, q.device)
    valid = torch.arange(W, device=q.device) < clen[:, None, None, None]
    s = torch.where(valid, s, MASK)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * _window_scale(v_scale, W)
    acc = torch.einsum("bgrk,bkgd->bgrd", p.to(dt).float(), vg.to(dt).float())
    return acc, m, l


def _write_token_ref(pool, table, clen, new) -> None:
    ps, P = pool.shape[1], table.shape[1]
    wp = torch.clamp(clen.long() // ps, max=P - 1)
    pages = table.long()[torch.arange(table.shape[0], device=table.device), wp]
    pool[pages, clen.long() % ps] = new.to(pool.dtype)


def paged_prefix_attention_update_ref(
    q, k_pool, v_pool, k_scale, v_scale, page_table, cache_len, k_new, v_new, sm_scale,
):
    """Plain version of the write-back variant: the attention of
    :func:`paged_prefix_attention_ref` (the new position is masked), then
    ``k_new`` / ``v_new`` (b, nkv·hd) written in place at row
    ``cache_len % ps`` of page ``table[t, min(cache_len // ps, P - 1)]``."""
    out = paged_prefix_attention_ref(q, k_pool, v_pool, k_scale, v_scale, page_table,
                                     cache_len, sm_scale)
    clen = cache_len_tensor(cache_len, q.shape[0], q.device)
    _write_token_ref(k_pool, page_table, clen, k_new)
    _write_token_ref(v_pool, page_table, clen, v_new)
    return out


def _smem_bytes(r: int, hd: int, P: int, ps: int) -> int:
    """Shared memory of a block with row tile ``r`` (``smem_bytes`` in the
    source): the q tile, 8 × min(r, 8) rows of acc parts, the r × W scores
    and the window's table row."""
    return (r * hd + _WARPS * min(r, _WARPS) * hd + r * P * ps + P) * 4


def _rows_per_tile(rs: int, hd: int, P: int, ps: int) -> int:
    """The largest power-of-2 row tile <= 32 (and <= rs rounded up) whose
    shared memory fits."""
    r = 1
    while r < min(rs, 32):
        r *= 2
    while r > 1 and _smem_bytes(r, hd, P, ps) > _SMEM_LIMIT:
        r //= 2
    if _smem_bytes(r, hd, P, ps) > _SMEM_LIMIT:
        raise ValueError(
            f"paged attention: window {P * ps} does not fit the kernel's shared memory")
    return r


def _launch(q, k_pool, v_pool, k_scale, v_scale, page_table, cache_len, k_new, v_new,
            sm_scale, what):
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"{what}: q is (b, nkv, rs, hd)")
    b, nkv, rs, hd = q.shape
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"{what}: q must be a contiguous bfloat16 tensor")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    if k_pool.dtype not in (torch.int8, torch.bfloat16) or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"{what}: pools must both be int8 or both bfloat16")
    if k_pool.dim() != 3 or v_pool.shape != k_pool.shape or k_pool.shape[2] != nkv * hd:
        raise ValueError(f"{what}: pools are (pages, page_size, {nkv * hd})")
    quant = k_pool.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: int8 pools need k_scale and v_scale, bf16 pools neither")
    ps = k_pool.shape[1]
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.stride(1) != 1:
        raise ValueError(f"{what}: page_table is int32 (b, P) with unit column stride")
    P = page_table.shape[1]
    W = P * ps
    scale_len = 0
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 3 \
                    or t.shape[0] != b or t.shape[1] < W or t.shape[2] != nkv:
                raise ValueError(f"{what}: {name} is contiguous f32 (b, L >= {W}, {nkv})")
        if k_scale.shape != v_scale.shape:
            raise ValueError(f"{what}: k_scale and v_scale differ in shape")
        scale_len = k_scale.shape[1]
    clen = cache_len_tensor(cache_len, b, dev)
    if clen.shape != (b,):
        raise ValueError(f"{what}: cache_len is an int or (b,)")
    if k_new is not None:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if t.dtype != k_pool.dtype or not t.is_contiguous() or t.shape != (b, nkv * hd):
                raise ValueError(f"{what}: {name} is contiguous {k_pool.dtype} (b, {nkv * hd})")
    tensors = [q, k_pool, v_pool, page_table, clen] + [
        t for t in (k_scale, v_scale, k_new, v_new) if t is not None]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: every tensor must be on {dev}")
    for t in (q, k_pool, v_pool, k_new, v_new):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: q, pools and new rows must be 16-byte aligned")
    if not k_pool.is_contiguous() or not v_pool.is_contiguous():
        raise ValueError(f"{what}: pools must be contiguous")

    acc = torch.empty((b, nkv, rs, hd), dtype=torch.float32, device=dev)
    m = torch.empty((b, nkv, rs, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, nkv, rs, 1), dtype=torch.float32, device=dev)
    if q.numel() == 0:
        return acc, m, l

    def ptr(t):
        return None if t is None else t.data_ptr()

    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
            page_table.data_ptr(), page_table.stride(0), clen.data_ptr())
    outs = (acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, nkv, rs, hd, ps, P, scale_len,
            int(quant))
    args = head + (ptr(k_new), ptr(v_new)) + outs
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = _build.sm_count(dev.index or 0)
    kernel = kernel_route(b, nkv, rs, hd, P, ps, k_new is not None, sms)
    if kernel == "paged_chunk_kernel":
        err = _chunk_fn()(*head, *outs, float(sm_scale), stream)
    elif kernel == "paged_decode_kernel":
        err = _decode_fn()(*args, *decode_plan(b, nkv, rs, hd, P, ps, sms), float(sm_scale),
                           stream)
    else:
        err = _fn()(*args, _rows_per_tile(rs, hd, P, ps), float(sm_scale), stream)
    _build.check("paged_attention", err, f"{what} launch")
    return acc, m, l


def paged_prefix_attention(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
    page_table: torch.Tensor, cache_len: CacheLen, *, sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Streaming-softmax state of ``q`` (b, nkv, rs, hd) over the paged
    cached prefix.  ``k_pool`` / ``v_pool``: (pages, ps, nkv·hd), int8 with
    dense per-slot ``k_scale`` / ``v_scale`` (b, L >= W, nkv) f32, or bf16
    with no scales.  ``page_table``: (b, P) int32, the pages of the window
    ``W = P·ps`` (a column slice of the full table is fine).
    ``cache_len``: valid prefix per slot.  The kernel takes bf16 ``q`` with
    hd 128."""
    if q.device.type == "cpu":
        return paged_prefix_attention_ref(q, k_pool, v_pool, k_scale, v_scale, page_table,
                                          cache_len, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefix_attention: unsupported device {q.device}")
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, page_table, cache_len, None, None,
                  sm_scale, "paged_prefix_attention")
    paged_prefix_attention.launches += 1
    return out


def paged_prefix_attention_update(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
    page_table: torch.Tensor, cache_len: CacheLen, k_new: torch.Tensor, v_new: torch.Tensor,
    *, sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`paged_prefix_attention` plus the decode step's pool write, in
    the same launch: ``k_new`` / ``v_new`` (b, nkv·hd, pool dtype) land in
    place at position ``cache_len`` of each slot (the caller's contract
    ``cache_len < W`` puts that page inside the window's table slice).  In
    the int8 mode the caller writes the new scales into the dense scale
    caches first; the new position is masked either way.  Returns
    ``(acc, m, l)``; the pools are updated in place."""
    if q.device.type == "cpu":
        return paged_prefix_attention_update_ref(q, k_pool, v_pool, k_scale, v_scale,
                                                 page_table, cache_len, k_new, v_new, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefix_attention_update: unsupported device {q.device}")
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, page_table, cache_len, k_new, v_new,
                  sm_scale, "paged_prefix_attention_update")
    paged_prefix_attention_update.launches += 1
    return out


paged_prefix_attention.launches = 0
paged_prefix_attention_update.launches = 0


def merge_attention_parts(acc_pre, m_pre, l_pre, acc_new, m_new, l_new) -> torch.Tensor:
    """Two-way streaming-softmax combine of the prefix state (from the
    kernel) with this step's new-token state, both f32; stats are (..., 1)
    or lane-broadcast (..., hd).  Returns the normalised context in f32."""
    hd = acc_pre.shape[-1]
    if m_pre.shape[-1] != hd:
        m_pre, l_pre = m_pre[..., :1], l_pre[..., :1]
    if m_new.shape[-1] not in (1, hd):
        m_new, l_new = m_new[..., :1], l_new[..., :1]
    m_tot = torch.maximum(m_pre, m_new)
    a_pre = torch.exp(m_pre - m_tot)
    a_new = torch.exp(m_new - m_tot)
    denom = l_pre * a_pre + l_new * a_new
    return (acc_pre * a_pre + acc_new * a_new) / denom
