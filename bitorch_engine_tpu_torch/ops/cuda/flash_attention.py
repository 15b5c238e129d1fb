"""Kernels 3 and 4: GQA-native flash attention, forward and backward.

The counterpart of ``bitorch_engine_tpu/ops/pallas/flash_attention.py``.
The kernels live in ``csrc/flash_attention.cu``: kernel 3 (the forward,
``flash_attention``) and kernel 4 (the backward, ``flash_attention_bwd``:
one launch for dq, one for dk / dv).  Each wrapper launches its kernels for
CUDA tensors, raises on what they do not take, and runs the plain version
beside them only for CPU tensors; ``<wrapper>.launches`` counts launches
(two per backward).  :class:`FlashAttention` is the differentiable
attention of training: its forward runs kernel 3 and saves the lse rows,
its backward runs kernel 4.

As the reference does, the forward rounds ``p`` to bf16 before the PV
product against the running max over key tiles of the reference's size
(:func:`pick_block`: 512, 256 or 128 keys); the backward rounds ``p``
before the dv product and ``ds`` before the dq / dk products.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

# query rows per block in the kernel; the model only dispatches s % 128 == 0
SEQ_MULTIPLE = 64
HEAD_DIMS = (64, 128)


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    return _build.function(
        "flash_attention", "bte_flash_fwd",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    )


@functools.lru_cache(maxsize=None)
def _dq_fn():
    return _build.function(
        "flash_attention", "bte_flash_bwd_dq",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    )


@functools.lru_cache(maxsize=None)
def _dkv_fn():
    return _build.function(
        "flash_attention", "bte_flash_bwd_dkv",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    )


def _check_shapes(q, k, v) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q is (b, nh, s, d); k and v are (b, nkv, s, d)")
    b, nh, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d:
        raise ValueError("flash attention needs matching q/k/v batch, sequence and head dim")
    nkv = k.shape[1]
    if nh % nkv:
        raise ValueError(f"num_heads {nh} is not a multiple of num_kv_heads {nkv}")
    return b, nh, nkv, s, d


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _check_kernel_operands(named, device) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned bf16
    tensor on ``device``."""
    for name, t in named:
        if t.device != device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bfloat16 tensor on {device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_kernel_shape(s: int, d: int) -> None:
    if s % SEQ_MULTIPLE or d not in HEAD_DIMS:
        raise ValueError(
            f"the flash kernels take s % {SEQ_MULTIPLE} == 0 and d in {HEAD_DIMS}, got s={s}, d={d}"
        )


def pick_block(s: int) -> int:
    """The reference's key tile for sequence ``s``: the first of 512, 256
    and 128 that divides it (the JAX wrapper's ``_pick_block``, which the
    model's calls reach: they pass no block size)."""
    for cand in (512, 256, 128):
        if s % cand == 0:
            return cand
    raise NotImplementedError(f"sequence {s} not a multiple of 128")


def _block_k(s: int, block_k: Optional[int]) -> int:
    bk = pick_block(s) if block_k is None else int(block_k)
    if bk <= 0 or s % bk:
        raise ValueError(f"block_k {bk} does not divide the sequence {s}")
    return bk


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, sm_scale: Optional[float] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the reference kernel's arithmetic as tensor math.

    Walks key tiles of ``block_k`` keys (``None``: :func:`pick_block`)
    with a running max ``m``: ``p = exp(s - m_new)`` in f32 is rounded to
    ``v.dtype`` before the PV product, ``l`` sums the unrounded ``p`` and
    the accumulator stays f32; ``out = acc / l``, ``lse = m + log l``.
    Returns ``(out in q.dtype, lse f32 (b, nh, s))``."""
    b, nh, nkv, s, d = _check_shapes(q, k, v)
    rep = nh // nkv
    scale = _scale(d, sm_scale)
    bk = _block_k(s, block_k)
    qg = q.float().reshape(b, nkv, rep, s, d)
    kf, vf = k.float(), v.float()
    m = torch.full((b, nkv, rep, s, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    rows = torch.arange(s, device=q.device)[:, None]
    # every row sees key 0, so m is finite after the first tile; a tile a
    # row cannot see leaves it as it was (alpha 1, p 0), as the reference's
    # skipped grid steps do
    for k0 in range(0, s, bk):
        sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kf[:, :, k0:k0 + bk]) * scale
        if causal:
            cols = torch.arange(k0, k0 + bk, device=q.device)[None, :]
            sc = sc.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bgrqk,bgkd->bgrqd", p.to(v.dtype).float(), vf[:, :, k0:k0 + bk]
        )
        m = m_new
    out = acc / l
    lse = m + torch.log(l)
    return out.reshape(b, nh, s, d).to(q.dtype), lse.reshape(b, nh, s)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, sm_scale: Optional[float] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``softmax(q kᵀ · sm_scale [+ causal]) v`` for q ``(b, nh, s, d)`` and
    k / v ``(b, nkv, s, d)``; query head ``h`` reads KV head ``h // (nh/nkv)``.
    ``p`` rounds to bf16 against the running max over key tiles of
    ``block_k`` keys (``None``: the reference's :func:`pick_block`).

    Returns ``(out (b, nh, s, d) bf16, lse (b, nh, s) f32)``.  The kernel
    takes contiguous bf16 operands, ``s % 64 == 0``, ``d`` in (64, 128) and
    a ``block_k`` that is a multiple of 64."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, sm_scale, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, nh, nkv, s, d = _check_shapes(q, k, v)
    _check_kernel_operands((("q", q), ("k", k), ("v", v)), q.device)
    _check_kernel_shape(s, d)
    bk = _block_k(s, block_k)
    if bk % SEQ_MULTIPLE:
        raise ValueError(f"the flash forward kernel takes block_k % {SEQ_MULTIPLE} == 0, got {bk}")
    scale = _scale(d, sm_scale)
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    err = _fwd_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * nh, s, d, nh // nkv, bk, scale, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", err, "flash_attention launch")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel 4: the reference's backward arithmetic as f32
    tensor math, with its casts (``p`` to ``do.dtype`` before the dv
    product, ``ds`` to ``q.dtype`` / ``k.dtype`` before the dk / dq
    products).  Returns ``(dq, dk, dv)`` in the operands' dtypes."""
    b, nh, nkv, s, d = _check_shapes(q, k, v)
    rep = nh // nkv
    scale = _scale(d, sm_scale)
    qg = q.float().reshape(b, nkv, rep, s, d)
    dog = do.float().reshape(b, nkv, rep, s, d)
    kf, vf = k.float(), v.float()
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kf) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~mask, float("-inf"))
    p = torch.exp(sc - lse.float().reshape(b, nkv, rep, s, 1))
    del sc
    delta = (do.float() * out.float()).sum(-1).reshape(b, nkv, rep, s, 1)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dog, vf)
    ds = p * (dp - delta) * scale
    del dp
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p.to(do.dtype).float(), dog)
    del p
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds.to(q.dtype).float(), qg)
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds.to(k.dtype).float(), kf)
    return dq.reshape(b, nh, s, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 4: ``(dq, dk, dv)`` of :func:`flash_attention` from its
    operands, its output, its lse rows and the output's cotangent ``do``.

    ``delta = sum_d do * out`` is one tensor expression here (the reference
    computes it outside its kernels too); then one launch writes dq and one
    writes dk and dv, each GQA group's query heads summed in the kernel.
    The kernels take what kernel 3 takes, with ``out`` and ``do`` shaped as
    ``q`` and ``lse`` as kernel 3 writes it."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    b, nh, nkv, s, d = _check_shapes(q, k, v)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError("out and do must be shaped as q")
    _check_kernel_operands(
        (("q", q), ("k", k), ("v", v), ("out", out), ("do", do)), q.device
    )
    if lse.shape != (b, nh, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 ({b}, {nh}, {s}) tensor")
    _check_kernel_shape(s, d)
    scale = _scale(d, sm_scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = (do.float() * out.float()).sum(-1).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rep = nh // nkv
    err = _dq_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * nh, s, d, rep, scale, int(causal), stream,
    )
    _build.check("flash_attention", err, "flash_attention_bwd dq launch")
    flash_attention_bwd.launches += 1
    err = _dkv_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * nkv, s, d, rep, scale,
        int(causal), stream,
    )
    _build.check("flash_attention", err, "flash_attention_bwd dkv launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: kernel 3 forward (its lse rows saved),
    kernel 4 backward; on CPU tensors both plain versions.  Use
    :func:`flash_attention_diff`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float],
                block_k: Optional[int] = None):
        out, lse = flash_attention(q, k, v, causal, sm_scale, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd hands the cotangent of a transposed view; the kernel
        # reads rows
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.sm_scale
        )
        return dq, dk, dv, None, None, None


def flash_attention_diff(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, sm_scale: Optional[float] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """:func:`flash_attention`'s output, differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, sm_scale, block_k)
