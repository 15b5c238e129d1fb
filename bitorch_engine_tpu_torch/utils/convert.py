"""Prepare a model for training, for inference or for the kernels, quantize
a plain model's linears, and load the JAX package's parameters, DiodeMix
moments and paged KV caches into the port.

``load_jax_params`` takes the flax parameter tree after
``jax.tree_util.tree_map(np.asarray, params)``: nested dicts of numpy
arrays, with each quantized weight still a record object whose fields are
numpy arrays.  It recognises such a record by its attributes and never
imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..layers.basic import Dense
from ..layers.linear import BinaryLinear, MBWQLinear, MPQLinear, QuantLayer
from ..models.paged_kv import PagedKV
from ..ops.cuda.dequant_matmul import prepare_for_kernel
from ..ops.quant import pack_binary_weight, quantize_mpq
from ..qtensor import (
    BinaryEmbeddingQTensor,
    BinaryQTensor,
    IntQTensor,
    MBWQTensor,
    MPQTensor,
    with_grad_shadow,
    without_grad_shadow,
)

_MPQ_FIELDS = ("packed", "scales", "zeros", "w_bit", "group_size", "asym", "layout")
_MBWQ_FIELDS = ("segments", "q_perm", "channel_scale", "block_perm", "perm_block")

# Strategy strings "w_bit-group_size-dq_group_size" (the reference's table)
MPQ_STRATEGIES: Dict[str, Tuple[int, int, int]] = {
    "2-8-32": (2, 8, 32),
    "2-32-32": (2, 32, 32),
    "2-128-32": (2, 128, 32),
    "4-128-256": (4, 128, 256),
    "8-128-256": (8, 128, 256),
}


def quantized_layers(model: nn.Module) -> List[nn.Module]:
    """Every layer whose weight is one quantized record of the JAX
    package's parameter tree: each ``MBWQLinear``, and each other
    quantized layer (MPQ, binary, IntQ, binary embedding) that is not a
    segment of an ``MBWQLinear``."""
    segments = {id(seg) for mod in model.modules() if isinstance(mod, MBWQLinear)
                for seg in mod.segments}
    return [mod for mod in model.modules()
            if isinstance(mod, (QuantLayer, MBWQLinear)) and id(mod) not in segments]


def get_mpq_config(strategy: str) -> Dict[str, int]:
    """Strategy string → ``{"w_bit", "group_size", "dq_group_size"}``."""
    if strategy not in MPQ_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; options: {sorted(MPQ_STRATEGIES)}")
    w_bit, group_size, dq_group_size = MPQ_STRATEGIES[strategy]
    return {"w_bit": w_bit, "group_size": group_size, "dq_group_size": dq_group_size}


@torch.no_grad()
def quantize_params(model: nn.Module, path_pattern: str = r"(kernel|weight)$",
                    strategy: str = "4-128-256", asym: bool = False) -> nn.Module:
    """Replace every fp linear whose weight path matches ``path_pattern``
    with an ``MPQLinear`` holding its weight quantized by ``strategy``, its
    bias kept: the counterpart of the JAX package's ``quantize_params`` +
    ``quantized_apply`` (a plain flax ``Dense`` whose kernel became an MPQ
    tensor computes ``mpq_linear(x, kernel) + bias``).  The path is flax's:
    ``<module path>/kernel`` for a ``Dense`` (kernel ``(in, out)``),
    ``<module path>/weight`` for an ``nn.Linear`` (weight ``(out, in)``,
    transposed).  Works in place; returns the model."""
    cfg = get_mpq_config(strategy)
    targets = []
    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            w, leaf = mod.kernel, "kernel"
        elif isinstance(mod, nn.Linear):
            w, leaf = mod.weight.T, "weight"
        else:
            continue
        if re.search(path_pattern, f"{name.replace('.', '/')}/{leaf}"):
            targets.append((name, mod, w))
    for name, mod, w in targets:
        k, n = w.shape
        qt = quantize_mpq(w.float(), w_bit=cfg["w_bit"], group_size=cfg["group_size"], asym=asym)
        new = MPQLinear(k, n, use_bias=mod.bias is not None, dtype=w.dtype, qweight=qt)
        if mod.bias is not None:
            new.bias.copy_(mod.bias)
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, attr, new)
    return model


def _record_tensors(qt) -> List[torch.Tensor]:
    out = []
    for f in dataclasses.fields(qt):
        v = getattr(qt, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(t for seg in v for t in _record_tensors(seg))
    return out


def count_quantized_bytes(model: nn.Module) -> Dict[str, int]:
    """The quantized records' bytes (every tensor of each record, grad
    shadows included) against their logical weights in fp16 (2 bytes times
    the first two logical dimensions, as the JAX package counts)."""
    packed = fp16 = 0
    for mod in quantized_layers(model):
        qt = mod.qweight
        packed += sum(t.numel() * t.element_size() for t in _record_tensors(qt))
        shape = qt.logical_shape
        fp16 += 2 * shape[0] * shape[1]
    return {"packed_bytes": packed, "fp16_bytes": fp16}


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
    """Inference mode: drop the grad shadows, pack the binary linears'
    weights to sign words (one bit a weight; kernel 8 reads them) and freeze
    every parameter.  Binary convs keep their int8 weights: neither package
    has a packed conv (the JAX package's packing of a conv weight would
    pack the wrong axis).  Works in place; returns the model."""
    for mod in quantized_layers(model):
        qt = without_grad_shadow(mod.qweight)
        if isinstance(mod, BinaryLinear):
            qt = pack_binary_weight(qt)
        mod.set_qweight(qt)
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
    if a.dtype == np.uint32:  # packed words: the same bits as int32
        a = a.view(np.int32)
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


def _qat_record(leaf: Any, device):
    """A binary, IntQ or binary-embedding record, or ``None``."""
    shadow = _tensor(getattr(leaf, "grad_shadow", None), device)
    if all(hasattr(leaf, f) for f in ("data", "scale_w", "packed", "in_features")):
        return BinaryQTensor(data=_tensor(leaf.data, device), scale_w=_tensor(leaf.scale_w, device),
                             grad_shadow=shadow, packed=bool(leaf.packed),
                             in_features=int(leaf.in_features))
    if all(hasattr(leaf, f) for f in ("data", "scale_w", "w_bit")):
        return IntQTensor(data=_tensor(leaf.data, device), scale_w=_tensor(leaf.scale_w, device),
                          w_bit=int(leaf.w_bit), grad_shadow=shadow)
    if all(hasattr(leaf, f) for f in ("data", "scale", "dim")):
        return BinaryEmbeddingQTensor(data=_tensor(leaf.data, device),
                                      scale=_tensor(leaf.scale, device), grad_shadow=shadow,
                                      dim=int(leaf.dim))
    return None


def _load_qweight(module: nn.Module, val: Any, where: str, device) -> None:
    if isinstance(module, MPQLinear) and _is_mpq(val):
        module.set_qweight(_mpq(val, device))
        return
    if isinstance(module, MBWQLinear) and _is_mbwq(val):
        module.set_qweight(_mbwq(val, device))
        return
    qt = _qat_record(val, device)
    if qt is None or not isinstance(module, QuantLayer) or not isinstance(qt, module._RECORD):
        raise ValueError(
            f"{where}: a quantized weight needs the layer of its record (MPQLinear, "
            f"MBWQLinear, a binary, IntQ or binary-embedding layer), not "
            f"{type(module).__name__}"
        )
    if qt.grad_shadow is not None and tuple(qt.grad_shadow.shape) != qt.logical_shape:
        # the JAX package's conv shadow (KH, KW): the port's has the full shape
        qt = with_grad_shadow(qt)
    module.set_qweight(qt)


def _load_into(module: nn.Module, tree: Mapping[str, Any], path: str, device) -> None:
    for key, val in tree.items():
        where = f"{path}/{key}" if path else key
        if key == "qweight":
            _load_qweight(module, val, where, device)
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
    """Copy the JAX package's parameters (Llama, ``QuantMLP``,
    ``QuantConvNet``, the QAT layers) into the port's model.

    Flax names map onto the port's modules one to one:
    ``layer_{i}/attn/qkv_proj/qweight``, ``layer_{i}/input_norm/weight``,
    ``embed`` (or ``embed/{data,scale}`` with ``quantize_embed``),
    ``final_norm/weight``, ``lm_head/qweight``, ``Dense_0/kernel``,
    ``BinaryLinear_0/scale_a``, ``qconv_0/qweight``, ``LayerNorm_1/scale``,
    ... .  The port's ``Dense``, ``Conv`` and ``LayerNorm`` keep flax's
    layouts (kernels ``(in, out)`` and HWIO), so fp leaves copy as they
    are.  A quantized weight (an MPQ record, an MBWQ record with its
    segments, ``q_perm``, ``block_perm``, ``perm_block`` and
    ``channel_scale``, a binary, IntQ or binary-embedding record, uint32
    words as int32) keeps its layout and regime (TPU layouts included)
    until :func:`prepare_params_for_cuda` converts it; a record that carries
    a ``grad_shadow`` (a tree after the JAX package's
    ``prepare_for_training``) gives its layer that shadow, of the port's
    full shape for a binary conv.  Returns the model."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    device = next(itertools.chain(model.buffers(), model.parameters())).device
    _load_into(model, tree, "", device)
    return model


@torch.no_grad()
def load_jax_diode_state(optimizer, state: Any) -> None:
    """Copy the JAX package's ``DiodeState`` (after ``tree_map(np.asarray,
    ...)``: ``step`` and ``leaf_states``, a tree of the parameters' paths
    holding ``{"exp_avg_l", "exp_avg_s"}`` dicts) into the port's
    ``DiodeMix``: the step count and every moment, by the flax path of
    its parameter or quantized layer.  The binary regimes' random initial
    ``exp_avg_s`` decides their first flips, so a run held against the JAX
    package starts from its moments.  GaLore states are not carried."""
    tree = state.leaf_states
    if set(tree) == {"params"}:
        tree = tree["params"]
    found = {}

    def walk(node, path):
        if isinstance(node, Mapping) and "exp_avg_s" in node:
            # a quantized layer's state is keyed by its module, others by parameter
            found[".".join(path[:-1] if path[-1] == "qweight" else path)] = node
            return
        for key, val in node.items():
            walk(val, path + (key,))

    walk(tree, ())
    if set(found) != set(optimizer.state):
        raise ValueError(f"DiodeState leaves {sorted(found)} != the optimizer's "
                         f"{sorted(optimizer.state)}")
    for name, moments in found.items():
        mine = optimizer.state[name]
        for key in ("exp_avg_l", "exp_avg_s"):
            if key in moments:
                src = _tensor(moments[key], mine[key].device)
                if tuple(src.shape) != tuple(mine[key].shape):
                    raise ValueError(f"{name}/{key}: shape {tuple(src.shape)} != "
                                     f"{tuple(mine[key].shape)}")
                mine[key].copy_(src)
    optimizer.step_count = int(np.asarray(state.step))


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
