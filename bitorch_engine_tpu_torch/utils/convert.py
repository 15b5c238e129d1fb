"""Prepare a model for training, for inference or for the kernels, and load
the JAX package's parameters and paged KV caches into the port.

``load_jax_params`` takes the flax parameter tree after
``jax.tree_util.tree_map(np.asarray, params)``: nested dicts of numpy
arrays, with each quantized weight still a record object whose fields are
numpy arrays.  It recognises such a record by its attributes and never
imports the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..layers.linear import MBWQLinear, MPQLinear
from ..models.paged_kv import PagedKV
from ..ops.cuda.dequant_matmul import prepare_for_kernel
from ..qtensor import MBWQTensor, MPQTensor, with_grad_shadow, without_grad_shadow

_MPQ_FIELDS = ("packed", "scales", "zeros", "w_bit", "group_size", "asym", "layout")
_MBWQ_FIELDS = ("segments", "q_perm", "channel_scale", "block_perm", "perm_block")


def quantized_layers(model: nn.Module) -> List[nn.Module]:
    """Every ``MBWQLinear`` and every ``MPQLinear`` that is not a segment
    of one: the layers whose weight is one quantized tensor of the JAX
    package's parameter tree."""
    segments = {id(seg) for mod in model.modules() if isinstance(mod, MBWQLinear)
                for seg in mod.segments}
    return [mod for mod in model.modules()
            if isinstance(mod, (MPQLinear, MBWQLinear)) and id(mod) not in segments]


def prepare_for_training(model: nn.Module) -> nn.Module:
    """Training mode: a zero f32 grad shadow on every quantized layer (the
    JAX package's ``prepare_for_training``), and ``requires_grad`` on every
    other parameter (embedding, norms, biases).  Works in place; returns
    the model."""
    for mod in quantized_layers(model):
        if mod.grad_shadow is None:
            mod.set_qweight(with_grad_shadow(mod.qweight))
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def prepare_for_inference(model: nn.Module) -> nn.Module:
    """Inference mode: drop the grad shadows and freeze every parameter.
    Works in place; returns the model."""
    for mod in quantized_layers(model):
        mod.set_qweight(without_grad_shadow(mod.qweight))
    for p in model.parameters():
        p.requires_grad_(False)
    return model


@torch.no_grad()
def prepare_params_for_cuda(
    model: nn.Module, meta_dtype: Optional[torch.dtype] = None,
    act_bits_map: Optional[Mapping[int, int]] = None,
) -> nn.Module:
    """Bring every quantized weight to the kernels' form once, at load time:
    symmetric zeros, gptq row order, group metadata in ``meta_dtype``
    (``torch.bfloat16`` halves the metadata stream).  The counterpart of
    ``relayout_params_for_tpu``: it covers ``MPQLinear`` layers and the
    segments of ``MBWQLinear`` layers (each held in an ``MPQLinear``).

    ``act_bits_map``: ``{container w_bit: act_bits}``, the decode regime per
    stored width, e.g. ``{2: 8}`` runs every 2-bit tensor or segment in the
    A8 regime (kernel 5) where ``prepare_for_kernel``'s rules allow it;
    widths not named keep their regime.  A second call with ``{2: 16}``
    flips the model back to A16 without requantizing.  Works in place;
    returns the model."""
    abm = dict(act_bits_map or {})
    for mod in model.modules():
        if isinstance(mod, MPQLinear):
            qt = mod.qweight
            mod.set_qweight(prepare_for_kernel(qt, meta_dtype, abm.get(qt.w_bit)))
    return model


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: carry the bits over
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _is_mpq(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in _MPQ_FIELDS)


def _mpq(leaf: Any, device) -> MPQTensor:
    code_bits = getattr(leaf, "code_bits", None)
    return MPQTensor(
        grad_shadow=_tensor(getattr(leaf, "grad_shadow", None), device),
        packed=_tensor(leaf.packed, device),
        scales=_tensor(leaf.scales, device),
        zeros=_tensor(leaf.zeros, device),
        g_idx=_tensor(getattr(leaf, "g_idx", None), device),
        q_perm=_tensor(getattr(leaf, "q_perm", None), device),
        w_bit=int(leaf.w_bit),
        group_size=int(leaf.group_size),
        asym=bool(leaf.asym),
        code_bits=None if code_bits is None else int(code_bits),
        layout=str(leaf.layout),
        act_bits=int(getattr(leaf, "act_bits", 16)),
        zeros_mid=bool(getattr(leaf, "zeros_mid", False)),
    )


def _is_mbwq(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in _MBWQ_FIELDS)


def _mbwq(leaf: Any, device) -> MBWQTensor:
    return MBWQTensor(
        grad_shadow=_tensor(getattr(leaf, "grad_shadow", None), device),
        segments=tuple(_mpq(seg, device) for seg in leaf.segments),
        q_perm=_tensor(leaf.q_perm, device),
        channel_scale=_tensor(leaf.channel_scale, device),
        block_perm=_tensor(leaf.block_perm, device),
        perm_block=int(leaf.perm_block),
    )


def _load_into(module: nn.Module, tree: Mapping[str, Any], path: str, device) -> None:
    for key, val in tree.items():
        where = f"{path}/{key}" if path else key
        if key == "qweight":
            if isinstance(module, MPQLinear) and _is_mpq(val):
                module.set_qweight(_mpq(val, device))
            elif isinstance(module, MBWQLinear) and _is_mbwq(val):
                module.set_qweight(_mbwq(val, device))
            else:
                raise ValueError(
                    f"{where}: a quantized weight needs an MPQLinear (MPQ record) or an "
                    "MBWQLinear (MBWQ record)"
                )
            continue
        target = getattr(module, key, None)
        if isinstance(val, Mapping):
            if not isinstance(target, nn.Module):
                raise KeyError(f"{where}: no such submodule in {type(module).__name__}")
            _load_into(target, val, where, device)
            continue
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"{where}: no such tensor in {type(module).__name__}")
        src = _tensor(val, device)
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError(f"{where}: shape {tuple(src.shape)} != {tuple(target.shape)}")
        target.copy_(src)


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy the JAX package's Llama parameters into the port's model.

    Flax names map onto the port's modules one to one:
    ``layer_{i}/attn/qkv_proj/qweight``, ``layer_{i}/input_norm/weight``,
    ``embed`` (or ``embed/{data,scale}`` with ``quantize_embed``),
    ``final_norm/weight``, ``lm_head/qweight``, ... .  A quantized weight
    (an MPQ record, or an MBWQ record with its segments, ``q_perm``,
    ``block_perm``, ``perm_block`` and ``channel_scale``) keeps its layout
    and regime (TPU layouts included) until :func:`prepare_params_for_cuda`
    converts it; a record that carries a ``grad_shadow`` (a tree after the
    JAX package's ``prepare_for_training``) gives its layer that shadow.
    Returns the model."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    device = next(iter(model.buffers())).device
    _load_into(model, tree, "", device)
    return model


def paged_kv_from_jax(caches: Sequence[Any], device=None) -> List[PagedKV]:
    """The JAX package's per-layer ``PagedKV`` caches (after
    ``jax.tree_util.tree_map(np.asarray, caches)``: records with numpy
    fields) as the port's, on ``device`` (``None`` means ``cuda``).  Each
    layer keeps its own copy of the page table, as in the JAX caches."""
    device = resolve_device(device)
    return [
        PagedKV(
            k_pool=_tensor(c.k_pool, device),
            v_pool=_tensor(c.v_pool, device),
            k_scale=_tensor(c.k_scale, device),
            v_scale=_tensor(c.v_scale, device),
            page_table=_tensor(c.page_table, device),
            kv_heads=int(c.kv_heads),
        )
        for c in caches
    ]
