"""Kernels 1 and 2: the fused dequant-matmul and the streaming dequant.

The counterpart of ``bitorch_engine_tpu/ops/pallas/dequant_matmul.py``.
Kernel 1 takes the "gptq" row order with symmetric float zeros (``w = q * s
- z``) and a tensor's stored rows; :func:`prepare_for_kernel` brings any
:class:`MPQTensor` to that form.  Kernel 1 has two bodies, picked up front
by :func:`mpq_matmul_route`: bf16 activations run kernel 7's tensor-core
body (``csrc/mbwq_matmul.cu``) with the tensor as its one segment, f32
activations the scalar ``mpq_matmul_kernel`` (``csrc/dequant_matmul.cu``).
Kernel 2 (``dequant_kernel``, same file) reads any gptq-order tensor as it
is stored: sym or asym zeros (:data:`ZERO_FORMS`), with a ``q_perm`` whose
rows it writes back in place.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; it runs the plain PyTorch version beside it only for
CPU tensors.  ``<wrapper>.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...qtensor import MPQTensor
from .. import packing
from ..quant import dequantize_mpq
from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _regime(qt: MPQTensor, act_bits: Optional[int]) -> MPQTensor:
    """The decode regime's activation width, by ``relayout_tpu``'s rules: A8
    only for ``w_bit`` in :data:`packing.QUAD_BITS` and a group count that
    is a multiple of ``8 / w_bit`` (else A16, so the port computes the JAX
    package's numbers); an A8 tensor whose zeros are exactly ``mid *
    scales`` is marked ``zeros_mid``."""
    if act_bits is not None:
        qt = qt.replace(act_bits=act_bits)
    if qt.act_bits not in (8, 16):
        raise ValueError(f"act_bits must be 8 or 16, got {qt.act_bits}")
    if qt.act_bits == 8 and (
        qt.w_bit not in packing.QUAD_BITS
        or (qt.in_features // qt.group_size) % packing.quad_superblock_groups(qt.w_bit)
    ):
        qt = qt.replace(act_bits=16)
    if qt.act_bits == 8 and not qt.asym and not qt.zeros_mid:
        mid = 2 ** ((qt.code_bits or qt.w_bit) - 1)
        if torch.equal(qt.zeros.float(), mid * qt.scales.float()):
            qt = qt.replace(zeros_mid=True)
    return qt


def prepare_for_kernel(
    qt: MPQTensor, meta_dtype: Optional[torch.dtype] = None, act_bits: Optional[int] = None
) -> MPQTensor:
    """Canonical kernel form: symmetric zeros, "gptq" row order, metadata in
    ``meta_dtype`` (float32 or bfloat16; ``None`` keeps it), and the decode
    regime ``act_bits`` (8 or 16; ``None`` keeps the tensor's).

    The asym→sym rewrite ``w = s(q - z) = q s - s z`` stores
    ``zeros = (s · z_int in f32).astype(scales.dtype)`` before the metadata
    cast, as ``relayout_tpu`` does; a TPU row layout (``tpu_quad``
    included) is unpacked and repacked in gptq order, which the A8 kernel
    reads as well.  The A8 regime falls back to A16 where ``relayout_tpu``
    does; unlike it, an 8-bit tensor asked for A8 is marked A16, the
    regime its TPU kernel runs.
    """
    qt = _regime(qt, act_bits)
    if qt.group_size % (32 // qt.w_bit) != 0:
        raise ValueError("group_size must be a multiple of 32 / w_bit")
    zeros = qt.zeros
    if qt.asym:
        z_int = packing.unpack_cols(qt.zeros, qt.w_bit).float()
        zeros = (qt.scales.float() * z_int).to(qt.scales.dtype)
    packed = qt.packed
    if qt.layout != "gptq":
        q_int = packing.unpack_rows_layout(packed, qt.w_bit, qt.group_size, qt.layout)
        packed = packing.pack_rows(q_int, qt.w_bit)
    scales = qt.scales
    if meta_dtype is not None:
        scales = scales.to(meta_dtype)
        zeros = zeros.to(meta_dtype)
    return qt.replace(
        packed=packed.contiguous(), scales=scales.contiguous(),
        zeros=zeros.contiguous(), asym=False, layout="gptq",
    )


def _check_weight(qt: MPQTensor, device: torch.device, act_bits=(16,)) -> None:
    """Raise unless ``qt`` is in kernel form, in one of the regimes
    ``act_bits``, on ``device``, at shapes and alignments kernels 1, 5 and
    7 take (kernel 2 checks with :func:`_check_dequant`)."""
    if qt.layout != "gptq" or qt.asym:
        raise ValueError(
            "the CUDA kernels take gptq-order symmetric tensors: "
            "call prepare_for_kernel (or utils.convert.prepare_params_for_cuda) first"
        )
    if qt.act_bits not in act_bits:
        raise ValueError(f"this kernel takes act_bits in {act_bits}, the tensor has {qt.act_bits}")
    if qt.g_idx is not None or qt.q_perm is not None:
        raise ValueError(
            "kernels 1, 5 and 7 take a tensor's stored rows: ops.mpq_linear gathers the "
            "activations by q_perm and sends a ragged g_idx past the kernels"
        )
    if qt.w_bit not in packing.SUPPORTED_BITS:
        raise ValueError(f"w_bit={qt.w_bit} unsupported")
    k, n = qt.logical_shape
    ppw = 32 // qt.w_bit
    if qt.group_size % ppw or k % qt.group_size:
        raise ValueError(f"K={k} and group_size={qt.group_size} must tile by {ppw}-code words")
    if n % 4:
        raise ValueError(f"N={n} must be a multiple of 4 (16-byte word loads)")
    if qt.packed.dtype != torch.int32:
        raise ValueError("packed must be int32")
    if qt.scales.dtype not in _DTYPE_CODE or qt.zeros.dtype != qt.scales.dtype:
        raise ValueError("scales and zeros must share one dtype, float32 or bfloat16")
    g = k // qt.group_size
    for name, t, shape in (
        ("packed", qt.packed, (k // ppw, n)),
        ("scales", qt.scales, (g, n)),
        ("zeros", qt.zeros, (g, n)),
    ):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the activations on {device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _mpq_fn():
    return _build.function(
        "dequant_matmul", "bte_mpq_matmul",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    )


@functools.lru_cache(maxsize=None)
def _dequant_fn():
    return _build.function(
        "dequant_matmul", "bte_dequant",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    )


def mpq_matmul_ref(
    x: torch.Tensor, qt: MPQTensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Plain version of kernel 1: ``x @ dequantize_mpq(qt)`` in f32, cast."""
    w = dequantize_mpq(qt, torch.float32)
    return (x.float() @ w).to(out_dtype or x.dtype)


def mpq_matmul_route(x_dtype: torch.dtype, qt: MPQTensor) -> str:
    """Kernel 1's body on the card: ``"mma"`` (kernel 7's tensor-core body,
    one segment) for bf16 activations and a group size its chunks tile (a
    multiple of 16 that the chunk of ``mbwq_matmul.chunk_words`` divides:
    every Llama configuration of the repo), else ``"scalar"``
    (``mpq_matmul_kernel``: f32 activations, or groups of 8 w4 / 4 w8 codes
    and the like)."""
    from .mbwq_matmul import tiles_group  # that module imports this one

    if x_dtype == torch.bfloat16 and tiles_group(qt.w_bit, qt.group_size):
        return "mma"
    return "scalar"


def mpq_matmul(
    x: torch.Tensor, qt: MPQTensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Kernel 1: ``x (m, K) @ dequant(qt) (K, N)`` with f32 accumulation.

    ``out_dtype`` defaults to ``x.dtype``; ``torch.float32`` returns the
    accumulator before any cast.  On the card the body is the one
    :func:`mpq_matmul_route` names; neither falls back to the other."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return mpq_matmul_ref(x, qt, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mpq_matmul: unsupported device {x.device}")
    _check_weight(qt, x.device)
    k, n = qt.logical_shape
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (m, {k}), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError("x and the output must be float32 or bfloat16")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    m = x.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    if mpq_matmul_route(x.dtype, qt) == "mma":
        from .mbwq_matmul import launch_mma  # that module imports this one

        # unsplit: a cluster along K measured slower at every 8B shape
        # (PERF.md §6)
        launch_mma(x, (qt,), out, "mpq_matmul launch", 1)
    else:
        err = _mpq_fn()(
            x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.zeros.data_ptr(),
            out.data_ptr(), m, k, n, qt.w_bit, qt.group_size,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[qt.scales.dtype], _DTYPE_CODE[out_dtype],
            _stream(x.device),
        )
        _build.check("dequant_matmul", err, "mpq_matmul launch")
    mpq_matmul.launches += 1
    return out


mpq_matmul.launches = 0


# Kernel 2's zero forms (csrc/dequant_matmul.cu ZeroForm): "sym" the stored
# float zeros, ``q·s − z``; "asym_kernel" an asym tensor's integer zeros in
# the kernel form, ``q·s − bf(s·z)`` (``s·z`` rounded to the scales' dtype,
# as ``prepare_for_kernel`` stores it); "asym_exact" the same zeros as
# ``s·(q − z)``, one f32 rounding (the plain ``dequantize_mpq``)
ZERO_FORMS = {"sym": 0, "asym_kernel": 1, "asym_exact": 2}


def zero_form(qt: MPQTensor, exact_asym: bool = False) -> str:
    """The zero form kernel 2 reads ``qt`` in: a sym tensor's float zeros,
    or an asym tensor's integer zeros in the kernel form or, with
    ``exact_asym``, as ``s·(q − z)``."""
    if not qt.asym:
        return "sym"
    return "asym_exact" if exact_asym else "asym_kernel"


def dequant_mpq_ref(
    qt: MPQTensor, dtype: torch.dtype = torch.bfloat16, exact_asym: bool = False
) -> torch.Tensor:
    """Plain version of kernel 2, in each zero form (:func:`zero_form`):
    the logical weight with the rows put back by ``q_perm``.  Sym and
    ``exact_asym``: :func:`dequantize_mpq` (``q·s − z`` rounded once, as the
    JAX package's jitted dequantize and the kernel's FMA; ``s·(q − z)``).
    The asym kernel form: ``dequantize_mpq(prepare_for_kernel(qt))``, the
    JAX TPU wrapper's arithmetic."""
    if zero_form(qt, exact_asym) == "asym_kernel":
        qt = prepare_for_kernel(qt)
    return dequantize_mpq(qt, dtype)


def _check_dequant(qt: MPQTensor, device: torch.device) -> None:
    """Raise unless kernel 2 takes ``qt`` on ``device``: gptq rows, any
    width of :data:`packing.SUPPORTED_BITS`, sym or asym zeros, an int32
    ``q_perm`` or none, no ``g_idx``, either regime."""
    if qt.layout != "gptq":
        raise ValueError("kernel 2 reads gptq row order: repack a TPU layout first")
    if qt.g_idx is not None:
        raise ValueError("a g_idx tensor takes the plain dequantize (ops.mpq_linear)")
    if qt.w_bit not in packing.SUPPORTED_BITS:
        raise ValueError(f"w_bit={qt.w_bit} unsupported")
    k, n = qt.logical_shape
    ppw = 32 // qt.w_bit
    if qt.group_size % ppw or k % qt.group_size:
        raise ValueError(f"K={k} and group_size={qt.group_size} must tile by {ppw}-code words")
    if qt.packed.dtype != torch.int32 or qt.scales.dtype not in _DTYPE_CODE:
        raise ValueError("packed must be int32, scales float32 or bfloat16")
    g = k // qt.group_size
    if qt.asym:
        if qt.zeros.dtype != torch.int32 or n % ppw:
            raise ValueError("asym zeros must be int32 words packed along N")
        zshape = (g, n // ppw)
    else:
        if qt.zeros.dtype != qt.scales.dtype:
            raise ValueError("scales and zeros must share one dtype, float32 or bfloat16")
        zshape = (g, n)
    parts = [("packed", qt.packed, (k // ppw, n)), ("scales", qt.scales, (g, n)),
             ("zeros", qt.zeros, zshape)]
    if qt.q_perm is not None:
        if qt.q_perm.dtype != torch.int32:
            raise ValueError("q_perm must be int32")
        parts.append(("q_perm", qt.q_perm, (k,)))
    for name, t, shape in parts:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the tensor's codes on {device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor, got {tuple(t.shape)}")


def dequant_mpq(
    qt: MPQTensor, dtype: torch.dtype = torch.bfloat16, exact_asym: bool = False
) -> torch.Tensor:
    """Kernel 2: the logical weight ``(K, N)`` in ``dtype``, bit-exact with
    :func:`dequant_mpq_ref`.  It takes sym and asym tensors (the zero form
    of :func:`zero_form`), with ``q_perm`` (its rows written back in place)
    or without, in either regime: prefill reconstructs the weight in both."""
    dev = qt.packed.device
    if dev.type == "cpu":
        return dequant_mpq_ref(qt, dtype, exact_asym)
    if dev.type != "cuda":
        raise ValueError(f"dequant_mpq: unsupported device {dev}")
    _check_dequant(qt, dev)
    if dtype not in _DTYPE_CODE:
        raise ValueError("dequant_mpq writes float32 or bfloat16")
    k, n = qt.logical_shape
    out = torch.empty((k, n), dtype=dtype, device=dev)
    # the vector path (16-byte loads and stores) wants every pointer aligned
    aligned = all(t.data_ptr() % 16 == 0 for t in (qt.packed, qt.scales, qt.zeros, out))
    err = _dequant_fn()(
        qt.packed.data_ptr(), qt.scales.data_ptr(), qt.zeros.data_ptr(),
        None if qt.q_perm is None else qt.q_perm.data_ptr(), out.data_ptr(),
        k, n, qt.w_bit, qt.group_size, _DTYPE_CODE[qt.scales.dtype], _DTYPE_CODE[dtype],
        ZERO_FORMS[zero_form(qt, exact_asym)], int(aligned), _stream(dev),
    )
    _build.check("dequant_matmul", err, "dequant_mpq launch")
    dequant_mpq.launches += 1
    return out


dequant_mpq.launches = 0
