"""MPQ weight-only linear, forward (the counterpart of ``ops/mpq_linear.py``).

Two regimes, as in the JAX package:

* decode: on the card the fused kernel reads the packed words once and
  never writes the weight out: kernel 1 for A16 tensors at ``m <=
  MAX_FUSED_ROWS_A16`` rows, kernel 5 for A8 tensors (``act_bits=8``:
  per-token int8 activations against the codes) at ``m <= MAX_FUSED_ROWS``.
  On the CPU an A8 tensor at ``m <= MAX_FUSED_ROWS`` takes the JAX
  package's exact simulation of its A8 kernel (kernel 5's plain version),
  an A16 tensor the second form below;
* prefill (more rows, and every A16 ``m`` on the CPU): the weight is
  reconstructed in ``x.dtype`` (kernel 2 on the card, in either regime) and
  ``torch.matmul`` runs the product (the JAX package leaves that product to
  XLA).

The regime is chosen from the tensor, the device and the shape up front;
nothing catches a kernel's error to fall back.

Act-order tensors follow the JAX package's branch rules.  A tensor with
``q_perm`` (a canonicalized act-order GPTQ checkpoint: rows stored sorted by
group) runs kernels 1 and 5 on its stored rows after a gather of the
activations, ``x[..., q_perm]``; kernel 2 writes its stored row ``r`` to
row ``q_perm[r]`` of the weight itself (the JAX package's scatter, in the
same launch).  A tensor with a ragged ``g_idx`` passes both kernels, as in
the JAX package: the plain dequantize (on the card too) and
``torch.matmul``, or in the A8 regime the JAX package's simulation of its
A8 kernel.  :data:`act_order_counts` counts the gathers, the kernel-2 calls
that write through ``q_perm`` and the plain reconstructions.

An asym tensor (a GPTQ export with ``qzeros``) computes on the card what
the JAX package's Pallas wrappers compute, ``w = q·s − (s·z)`` with the
product ``s·z`` rounded to the scales' dtype: kernels 1 and 5 run its
stored rows rewritten on the fly by ``prepare_for_kernel``
(:func:`_kernel_form`, as is a TPU row layout), and kernel 2 reads its
packed integer zeros itself (that form, or DiodeMix's exact ``s·(q − z)``
with ``exact_asym``), with no rewrite.  A symmetric gptq tensor goes to the
kernels as it is, with no rewrite and no host sync.  On the CPU the plain
dequantize keeps the JAX CPU path's ``s·(q − z)``.

The backward (``_mpq_bwd`` of the JAX package) runs when the input or the
tensor's grad shadow needs a gradient: ``grad_input = g @ Wᵀ`` with the
weight reconstructed again (kernel 2 on the card), and the full-rank
weight cotangent ``xᵀ g`` in f32 delivered to the grad shadow.  No
gradient goes to the scales or zeros: DiodeMix refreshes the zeros itself.
"""

from __future__ import annotations

import torch

from ..qtensor import MPQTensor
from . import packing
from .cuda.dequant_matmul import dequant_mpq, mpq_matmul, prepare_for_kernel
from .cuda.quad_matmul import mpq_matmul_a8, mpq_matmul_a8_ref
from .quant import dequantize_mpq

# The A8 regime's row limit, the crossover the JAX package measured on a
# TPU v5e.  It decides whether the activations are quantized to int8, so
# the numbers, and stays the reference's on every device.
MAX_FUSED_ROWS = 512
# The A16 crossover on the card: kernel 1 against kernel 2 + torch.matmul
# at the Llama-3-8B projections and head, m 16-512 (chip_smoke.py phase 3,
# PERF.md §6, H100 80GB HBM3 at 700 W): kernel 1 wins to m = 64 at every
# shape and loses from m = 128.  Kernel 7, on the same body, measured the
# same cut-off and uses it (ops/mbwq_linear.py).
MAX_FUSED_ROWS_A16 = 64

# the act-order routes taken, by kind: "gather" (activations gathered by
# q_perm for kernel 1 or 5), "scatter" (kernel-2 calls that write their rows
# through q_perm, on the card: no launch of their own) and "plain" (a ragged
# g_idx tensor through the plain dequantize); the caller resets them
act_order_counts = {"gather": 0, "scatter": 0, "plain": 0}


def _stored(qt: MPQTensor) -> MPQTensor:
    """The tensor as its rows are stored (no ``q_perm``): what kernels 1
    and 5 take."""
    return qt if qt.q_perm is None else qt.replace(q_perm=None)


def _kernel_form(qt: MPQTensor) -> MPQTensor:
    """The stored rows in kernels 1 and 5's form: a symmetric gptq tensor
    as it is; an asym one or a TPU row layout rewritten by
    ``prepare_for_kernel`` (``mpq_matmul_pallas`` does the same)."""
    qt = _stored(qt)
    if qt.asym or qt.layout != "gptq":
        qt = prepare_for_kernel(qt)
    return qt


def _gather(x2d: torch.Tensor, qt: MPQTensor) -> torch.Tensor:
    """Activations in the tensor's stored row order, ``x[:, q_perm]``."""
    if qt.q_perm is None:
        return x2d
    act_order_counts["gather"] += 1
    return x2d.index_select(1, qt.q_perm)


def _gptq_rows(qt: MPQTensor) -> MPQTensor:
    """A TPU row layout repacked in gptq order (zeros untouched): what
    kernel 2 reads; a gptq tensor as it is."""
    if qt.layout == "gptq":
        return qt
    q = packing.unpack_rows_layout(qt.packed, qt.w_bit, qt.group_size, qt.layout)
    return qt.replace(packed=packing.pack_rows(q, qt.w_bit), layout="gptq")


def reconstruct_weight(qt: MPQTensor, dtype: torch.dtype, exact_asym: bool = False) -> torch.Tensor:
    """Logical fp weight ``(K, N)``: on the card one kernel-2 launch, which
    reads sym and asym zeros and writes the rows back through ``q_perm``
    itself (an asym tensor in the kernel form ``q·s − (s·z)``, or as
    ``s·(q − z)`` with ``exact_asym``); the plain dequantize for a ragged
    ``g_idx`` on the card, and for every tensor on the CPU."""
    if qt.g_idx is not None:
        act_order_counts["plain"] += 1
    if qt.device.type != "cuda" or qt.g_idx is not None:
        return dequantize_mpq(qt, dtype)
    if qt.q_perm is not None:
        act_order_counts["scatter"] += 1
    return dequant_mpq(_gptq_rows(qt), dtype, exact_asym)


def weight_grad(x2d: torch.Tensor, g2d: torch.Tensor) -> torch.Tensor:
    """``x2dᵀ @ g2d`` accumulated and returned in f32, as the JAX package's
    ``preferred_element_type=f32`` dot: bf16 operands on the card go to
    cuBLAS's f32-output GEMM; other operands are upcast (products of bf16
    values are exact in f32)."""
    if x2d.is_cuda and x2d.dtype == torch.bfloat16 and g2d.dtype == torch.bfloat16:
        return torch.mm(x2d.T, g2d, out_dtype=torch.float32)
    return torch.matmul(x2d.T.float(), g2d.float())


def needs_grad(x: torch.Tensor, shadow) -> bool:
    """Whether a quantized linear must record its backward."""
    return torch.is_grad_enabled() and (
        x.requires_grad or (shadow is not None and shadow.requires_grad)
    )


class _MPQLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shadow, qt, out_dtype):
        ctx.save_for_backward(x)
        ctx.qt = qt
        return _mpq_forward(x, qt, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        qt = ctx.qt
        k = x.shape[-1]
        g2d = g.reshape(-1, g.shape[-1]).to(x.dtype)
        grad_x = gw = None
        if ctx.needs_input_grad[0]:
            w = reconstruct_weight(qt, x.dtype)
            grad_x = torch.matmul(g2d, w.T).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = weight_grad(x.reshape(-1, k), g2d)
        return grad_x, gw, None, None


def mpq_linear(x: torch.Tensor, qt: MPQTensor, out_dtype=None) -> torch.Tensor:
    """``x (..., K) @ dequant(qt)`` → ``(..., N)`` in ``out_dtype`` (default
    ``x.dtype``), differentiable in ``x`` and in ``qt.grad_shadow``.
    ``out_dtype=torch.float32`` returns the f32 product before any cast (a
    row-parallel shard's partial sum); its backward reads the cotangent in
    ``x.dtype``, as the cast after the unsharded product hands it back."""
    if needs_grad(x, qt.grad_shadow):
        return _MPQLinear.apply(x, qt.grad_shadow, qt, out_dtype)
    return _mpq_forward(x, qt, out_dtype)


def mpq_route(qt: MPQTensor, m: int, device_type: str) -> str:
    """The forward's route for ``m`` rows on ``device_type``: ``"a8"``
    (kernel 5, its plain version on the CPU), ``"a8_plain"`` (the A8
    regime's plain simulation, for a ragged ``g_idx``), ``"a16"`` (kernel
    1, on the card only) or ``"reconstruct"`` (the weight, then
    ``torch.matmul``).  Sym and asym tensors take the same routes: on the
    card kernels 1 and 5 run an asym tensor's kernel form
    (:func:`_kernel_form`) and kernel 2 reads its zeros in that form; on
    the CPU kernel 5's plain version and the dequantize read it as it is."""
    if qt.act_bits == 8 and m <= MAX_FUSED_ROWS:
        return "a8_plain" if qt.g_idx is not None else "a8"
    if device_type == "cuda" and m <= MAX_FUSED_ROWS_A16 and qt.g_idx is None:
        return "a16"
    return "reconstruct"


def _matmul_f32(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x2d @ w`` accumulated and returned in f32 (``weight_grad``'s form)."""
    if x2d.is_cuda and x2d.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        return torch.mm(x2d, w, out_dtype=torch.float32)
    return torch.matmul(x2d.float(), w.float())


def _mpq_forward(x: torch.Tensor, qt: MPQTensor, out_dtype=None) -> torch.Tensor:
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2d = x.reshape(-1, k)
    route = mpq_route(qt, x2d.shape[0], x.device.type)
    if route == "a8_plain":
        act_order_counts["plain"] += 1
        out = mpq_matmul_a8_ref(x2d, qt, out_dtype)
    elif route == "a8":
        kt, a8 = _stored(qt), mpq_matmul_a8
        if x.device.type == "cuda":
            # the rewrite keeps A8 where relayout_tpu does, else A16 (kernel 1)
            kt = _kernel_form(qt)
            a8 = mpq_matmul_a8 if kt.act_bits == 8 else mpq_matmul
        out = a8(_gather(x2d, qt).contiguous(), kt, out_dtype)
    elif route == "a16":
        out = mpq_matmul(_gather(x2d, qt).contiguous(), _kernel_form(qt), out_dtype)
    else:
        w = reconstruct_weight(qt, x.dtype)
        out = torch.matmul(x2d, w) if out_dtype is None else _matmul_f32(x2d, w).to(out_dtype)
    return out.reshape(*lead, -1)
