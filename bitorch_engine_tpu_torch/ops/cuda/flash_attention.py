"""Kernel 3: causal, GQA-native flash attention forward.

The counterpart of ``bitorch_engine_tpu/ops/pallas/flash_attention.py``
(forward only; the backward kernels come with the training slice).  The
kernel lives in ``csrc/flash_attention.cu``; the wrapper launches it for
CUDA tensors, raises on what it does not take, and runs the plain version
beside it only for CPU tensors.  ``flash_attention.launches`` counts
launches.
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
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
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


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 scores and softmax on the given inputs.

    Returns ``(out in q.dtype, lse f32 (b, nh, s))``."""
    b, nh, nkv, s, d = _check_shapes(q, k, v)
    rep = nh // nkv
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    qg = q.float().reshape(b, nkv, rep, s, d)
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(sc, dim=-1)
    p = torch.exp(sc - lse[..., None])
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return out.reshape(b, nh, s, d).to(q.dtype), lse.reshape(b, nh, s)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``softmax(q kᵀ · sm_scale [+ causal]) v`` for q ``(b, nh, s, d)`` and
    k / v ``(b, nkv, s, d)``; query head ``h`` reads KV head ``h // (nh/nkv)``.

    Returns ``(out (b, nh, s, d) bf16, lse (b, nh, s) f32)``.  The kernel
    takes contiguous bf16 operands, ``s % 64 == 0`` and ``d`` in (64, 128)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, nh, nkv, s, d = _check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bfloat16 tensor on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if s % SEQ_MULTIPLE or d not in HEAD_DIMS:
        raise ValueError(
            f"the flash kernel takes s % {SEQ_MULTIPLE} == 0 and d in {HEAD_DIMS}, got s={s}, d={d}"
        )
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    out = torch.empty_like(q)
    lse = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    err = _fwd_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * nh, s, d, nh // nkv, scale, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_attention", err, "flash_attention launch")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
