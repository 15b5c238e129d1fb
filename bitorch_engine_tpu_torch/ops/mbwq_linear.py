"""MBWQ: the mixed-bit-width (channel-mix) linear, forward, in PyTorch.

The counterpart of ``bitorch_engine_tpu/ops/mbwq_linear.py``, bit-exact with
its quantizer and dequantizer.  Input-channel blocks of one weight are
quantized at different bit widths (the blocks with the most energy get the
most bits) and sorted into contiguous per-bit segments, each a uniform
:class:`MPQTensor`; the forward gathers the activations into segment order
and sums the segments' products.

Dispatch of the forward (``m`` rows after flattening):

* on the card, ``m <= MAX_FUSED_ROWS_A16`` and every segment A16 without
  ``g_idx`` / ``q_perm``: kernel 7, one launch over all segments with one
  f32 accumulator (the JAX package keeps this kernel behind
  ``BITORCH_MBWQ_FUSED``; the port takes it whenever these conditions hold).
  Kernel 7 shares kernel 1's body and its cut-off: against the per-segment
  form below it wins to m = 64 at every Llama-2-7B MBWQ-2.5 projection and
  loses from m = 128 (``chip_smoke.py`` phase 8b, PERF.md §6);
* otherwise (an A8 segment, or prefill): one ``mpq_linear`` per segment,
  summed in ``x.dtype``; on the CPU always this form, as the JAX package
  runs off the TPU.

The backward (``_mbwq_bwd`` of the JAX package) runs when the input or the
tensor's grad shadow needs a gradient: the logical weight is rebuilt
(kernel 2 per segment on the card, rows scattered back by ``q_perm``) and
scaled by ``channel_scale`` for ``grad_input``; the weight cotangent is
``(x · channel_scale)ᵀ g`` in f32, in the logical row order.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import torch

from ..qtensor import MBWQTensor
from . import packing
from .cuda.mbwq_matmul import mbwq_matmul
from .mpq_linear import (
    MAX_FUSED_ROWS_A16, mpq_linear, needs_grad, reconstruct_weight, weight_grad,
)
from .quant import dequantize_mpq, quantize_mpq


def strategy_dict(entries, default_gs: int, container_bits=None, mid_sym: bool = False) -> Dict:
    """The reference-format strategy dict from ``(bits, proportion[,
    group_size])`` entries, e.g. ``LlamaConfig.mbwq_strategy``; a third
    element overrides ``default_gs`` for that width."""
    bits, props, gss = [], [], {}
    for entry in entries:
        b, p = int(entry[0]), float(entry[1])
        bits.append(b)
        props.append(p)
        gss[str(b)] = int(entry[2]) if len(entry) > 2 else int(default_gs)
    strat = {"bits": bits, "bits_prop": props, "group_size": gss}
    if container_bits:
        strat["container_bits"] = {str(kk): int(v) for kk, v in dict(container_bits).items()}
    if mid_sym:
        strat["mid_sym"] = True
    return strat


def _fit_group_size(requested: int, seg_k: int, w_bit: int) -> int:
    """Largest group size ≤ ``requested`` that divides the segment's K and
    keeps whole packed words per group (``w_bit`` is the container)."""
    ppw = 32 // w_bit
    gs = min(requested, seg_k)
    while gs > ppw and (seg_k % gs != 0 or gs % ppw != 0):
        gs -= ppw
    if seg_k % gs != 0 or gs % ppw != 0:
        raise ValueError(f"no valid group size ≤ {requested} for segment K={seg_k}, w_bit={w_bit}")
    return gs


def _segment_counts(bits: Sequence[int], props: Sequence[float], n_blocks: int, align: int = 1):
    """Per-bit block counts from the proportions, each rounded to a multiple
    of ``align`` but the last, which takes the rest."""
    counts = []
    used = 0
    for i, (_, p) in enumerate(zip(bits, props)):
        if i < len(bits) - 1:
            c = int(round(p * n_blocks / align)) * align
        else:
            c = n_blocks - used
        c = max(0, min(c, n_blocks - used))
        counts.append(c)
        used += c
    if used < n_blocks:
        counts[-1] += n_blocks - used
    return counts


def quantize_mbwq(
    weight: torch.Tensor, strategy: Dict, channel_scale: Optional[torch.Tensor] = None
) -> MBWQTensor:
    """fp weight ``(K, N)`` → :class:`MBWQTensor` per a mixed-bit strategy.

    Blocks of ``base_gs`` rows (the smallest group size) are ranked by
    their energy (the f32 sum of squares), in a stable descending sort; the
    widest bit width takes the first blocks.  Segment sizes are rounded to
    ``8 * gs / base_gs`` blocks (halved until they divide the block count),
    so every segment's group count stays a multiple of 8; a segment whose
    group size does not divide its rows gets the largest one that does, with
    a warning.  As in the JAX package, a block-norm tie decided by an f32
    sum in another order may rank the other way."""
    bits = [int(b) for b in strategy["bits"]]
    props = [float(p) for p in strategy["bits_prop"]]
    gs_map = {int(kk): int(v) for kk, v in strategy.get("group_size", {}).items()}
    cont_map = {int(kk): int(v) for kk, v in strategy.get("container_bits", {}).items()}
    mid_sym = bool(strategy.get("mid_sym", False))
    base_gs = min(gs_map.values()) if gs_map else 32

    k, _ = weight.shape
    n_blocks = k // base_gs
    w = weight.float()
    norms = torch.sum(w * w, dim=1).reshape(n_blocks, base_gs).sum(dim=1)
    order = torch.argsort(-norms, stable=True)

    align = 1
    for b in bits:
        align = max(align, 8 * max(gs_map.get(b, base_gs) // base_gs, 1))
    while align > 1 and n_blocks % align != 0:
        align //= 2
    counts = _segment_counts(bits, props, n_blocks, align)
    if any(c == 0 and p > 0 for c, p in zip(counts, props)):
        # too small for aligned splits: keep every requested segment
        counts = _segment_counts(bits, props, n_blocks)

    segments, perm_parts = [], []
    start = 0
    row_offsets = torch.arange(base_gs, dtype=torch.int32, device=w.device)[None, :]
    for b, cnt in sorted(zip(bits, counts), reverse=True):  # widest first
        if cnt == 0:
            continue
        blocks = order[start : start + cnt]
        rows = (blocks[:, None].to(torch.int32) * base_gs + row_offsets).reshape(-1)
        perm_parts.append(rows)
        container = cont_map.get(b, packing.CONTAINER_BITS.get(b))
        if container is None:
            raise ValueError(f"unsupported bits={b}; choose from {sorted(packing.CONTAINER_BITS)}")
        if container < b:
            raise ValueError(f"container_bits[{b}]={container} < code width")
        gs_req = gs_map.get(b, base_gs)
        gs = _fit_group_size(gs_req, cnt * base_gs, container)
        if gs != gs_req:
            warnings.warn(
                f"mbwq segment w{b} (K={cnt * base_gs}): requested group_size {gs_req} "
                f"does not divide; fitted to {gs}",
                stacklevel=2,
            )
        segments.append(quantize_mpq(
            w[rows.long()], w_bit=container, group_size=gs, asym=False,
            code_bits=None if container == b else b, mid_sym=mid_sym,
        ))
        start += cnt
    perm = torch.cat(perm_parts)
    return MBWQTensor(
        segments=tuple(segments), q_perm=perm, channel_scale=channel_scale,
        block_perm=(perm[::base_gs] // base_gs).to(torch.int32), perm_block=base_gs,
    )


def dequantize_mbwq(qt: MBWQTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The logical fp weight ``(K, N)``: the segments reconstructed in f32,
    rows scattered back by ``q_perm``; ``channel_scale`` (an activation
    pre-scale) is not applied."""
    stored = torch.cat([dequantize_mpq(seg, torch.float32) for seg in qt.segments], dim=0)
    if qt.q_perm is not None:
        w = torch.zeros_like(stored)
        w[qt.q_perm.long()] = stored
    else:
        w = stored
    return w.to(dtype)


def gather_activations(x: torch.Tensor, qt: MBWQTensor) -> torch.Tensor:
    """``x (..., K)`` × ``channel_scale``, gathered into segment order: whole
    ``perm_block``-row blocks by ``block_perm`` when the permutation is
    block-structured, else row by row by ``q_perm``."""
    if qt.channel_scale is not None:
        x = x * qt.channel_scale.to(x.dtype)
    if qt.q_perm is None:
        return x
    pb = qt.perm_block
    if pb and x.shape[-1] % pb == 0:
        nb = x.shape[-1] // pb
        bp = qt.block_perm if qt.block_perm is not None else qt.q_perm[::pb] // pb
        x3 = x.reshape(x.shape[:-1] + (nb, pb))
        return x3[..., bp.long(), :].reshape(x.shape)
    return x[..., qt.q_perm.long()]


def _fused_ok(x2d: torch.Tensor, qt: MBWQTensor) -> bool:
    return (
        x2d.device.type == "cuda"
        and x2d.shape[0] <= MAX_FUSED_ROWS_A16
        and all(s.act_bits == 16 and s.g_idx is None and s.q_perm is None for s in qt.segments)
    )


def reconstruct_mbwq(qt: MBWQTensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`dequantize_mbwq` with each segment rebuilt by kernel 2 on the
    card (bit-exact with the plain dequantize), the plain version on the
    CPU."""
    stored = torch.cat([reconstruct_weight(seg, torch.float32) for seg in qt.segments], dim=0)
    if qt.q_perm is None:
        return stored.to(dtype)
    w = torch.zeros_like(stored)
    w[qt.q_perm.long()] = stored
    return w.to(dtype)


class _MBWQLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shadow, qt):
        ctx.save_for_backward(x)
        ctx.qt = qt
        return _mbwq_forward(x, qt)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        qt = ctx.qt
        k = x.shape[-1]
        g2d = g.reshape(-1, g.shape[-1]).to(x.dtype)
        cs = None if qt.channel_scale is None else qt.channel_scale.to(x.dtype)
        grad_x = gw = None
        if ctx.needs_input_grad[0]:
            w = reconstruct_mbwq(qt, x.dtype)
            if cs is not None:
                w = w * cs[:, None]
            grad_x = torch.matmul(g2d, w.T).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            x2d = x.reshape(-1, k)
            if cs is not None:
                x2d = x2d * cs
            gw = weight_grad(x2d, g2d)
        return grad_x, gw, None


def mbwq_linear(x: torch.Tensor, qt: MBWQTensor) -> torch.Tensor:
    """``(x · channel_scale) @ dequant(qt)`` → ``(..., N)`` in ``x.dtype``,
    differentiable in ``x`` and in ``qt.grad_shadow``."""
    if needs_grad(x, qt.grad_shadow):
        return _MBWQLinear.apply(x, qt.grad_shadow, qt)
    return _mbwq_forward(x, qt)


def _mbwq_forward(x: torch.Tensor, qt: MBWQTensor) -> torch.Tensor:
    xp = gather_activations(x, qt)
    lead = xp.shape[:-1]
    x2d = xp.reshape(-1, xp.shape[-1])
    if _fused_ok(x2d, qt):
        return mbwq_matmul(x2d.contiguous(), qt).reshape(*lead, -1)
    out = None
    off = 0
    for seg in qt.segments:
        k_seg = seg.in_features
        contrib = mpq_linear(xp[..., off : off + k_seg], seg)
        out = contrib if out is None else out + contrib
        off += k_seg
    return out


def average_bits(qt: MBWQTensor) -> float:
    """Average quantization bits per weight (true code widths)."""
    return sum(seg.quant_bits * seg.in_features for seg in qt.segments) / qt.in_features


def average_storage_bits(qt: MBWQTensor) -> float:
    """Average stored bits per weight (container widths)."""
    return sum(seg.w_bit * seg.in_features for seg in qt.segments) / qt.in_features
