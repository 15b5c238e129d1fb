"""Prepare a model for training, for inference or for the kernels, quantize
a plain model's linears, and load the JAX package's parameters, DiodeMix
moments and paged KV caches into the port.

``load_jax_params`` takes the flax parameter tree after
``jax.tree_util.tree_map(np.asarray, params)``: nested dicts of numpy
arrays, with each quantized weight still a record object whose fields are
numpy arrays.  It recognises such a record by its attributes and never
imports the JAX package.  It takes the same tree with torch tensors and the
port's records, as :func:`params_tree` makes it from a model and
``utils.checkpoint.load_checkpoint`` restores it, and fills a skeleton
model built on the ``meta`` device.
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
from ..layers.linear import MBWQLinear, MPQLinear, QuantLayer
from ..models.llama import MoEExpert
from ..models.paged_kv import PagedKV
from ..ops.cuda.dequant_matmul import prepare_for_kernel
from ..ops.quant import check_row_map, pack_binary_weight, quantize_mpq
from ..qtensor import (
    BinaryEmbeddingQTensor,
    BinaryQTensor,
    IntQTensor,
    MBWQTensor,
    MPQTensor,
    with_grad_shadow,
    without_grad_shadow,
)
from .ingest import as_tensor

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


def inference_record(qt):
    """A quantized record as inference mode holds it: no grad shadow, and a
    binary linear's weight (the 2-d QAT form) packed to sign words.  A binary
    conv's weight (4-d) stays int8: neither package has a packed conv (the
    JAX package's packing of a conv weight would pack the wrong axis)."""
    qt = without_grad_shadow(qt)
    if isinstance(qt, BinaryQTensor) and qt.data.dim() == 2:
        qt = pack_binary_weight(qt)
    return qt


def prepare_for_inference(model: nn.Module) -> nn.Module:
    """Inference mode: every quantized record as :func:`inference_record`
    leaves it (binary linears' weights packed to sign words, which kernel 8
    reads) and every parameter frozen.  Works in place; returns the model."""
    for mod in quantized_layers(model):
        mod.set_qweight(inference_record(mod.qweight))
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


def _is_mpq(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in _MPQ_FIELDS)


def _mpq(leaf: Any, device) -> MPQTensor:
    code_bits = getattr(leaf, "code_bits", None)
    qt = MPQTensor(
        grad_shadow=as_tensor(getattr(leaf, "grad_shadow", None), device),
        packed=as_tensor(leaf.packed, device),
        scales=as_tensor(leaf.scales, device),
        zeros=as_tensor(leaf.zeros, device),
        g_idx=as_tensor(getattr(leaf, "g_idx", None), device),
        q_perm=as_tensor(getattr(leaf, "q_perm", None), device),
        w_bit=int(leaf.w_bit),
        group_size=int(leaf.group_size),
        asym=bool(leaf.asym),
        code_bits=None if code_bits is None else int(code_bits),
        layout=str(leaf.layout),
        act_bits=int(getattr(leaf, "act_bits", 16)),
        zeros_mid=bool(getattr(leaf, "zeros_mid", False)),
    )
    if qt.q_perm is not None:
        check_row_map(qt.q_perm, qt.in_features)
    return qt


def _is_mbwq(leaf: Any) -> bool:
    return all(hasattr(leaf, f) for f in _MBWQ_FIELDS)


def _mbwq(leaf: Any, device) -> MBWQTensor:
    return MBWQTensor(
        grad_shadow=as_tensor(getattr(leaf, "grad_shadow", None), device),
        segments=tuple(_mpq(seg, device) for seg in leaf.segments),
        q_perm=as_tensor(leaf.q_perm, device),
        channel_scale=as_tensor(leaf.channel_scale, device),
        block_perm=as_tensor(leaf.block_perm, device),
        perm_block=int(leaf.perm_block),
    )


def _qat_record(leaf: Any, device):
    """A binary, IntQ or binary-embedding record, or ``None``."""
    shadow = as_tensor(getattr(leaf, "grad_shadow", None), device)
    if all(hasattr(leaf, f) for f in ("data", "scale_w", "packed", "in_features")):
        return BinaryQTensor(data=as_tensor(leaf.data, device), scale_w=as_tensor(leaf.scale_w, device),
                             grad_shadow=shadow, packed=bool(leaf.packed),
                             in_features=int(leaf.in_features))
    if all(hasattr(leaf, f) for f in ("data", "scale_w", "w_bit")):
        return IntQTensor(data=as_tensor(leaf.data, device), scale_w=as_tensor(leaf.scale_w, device),
                          w_bit=int(leaf.w_bit), grad_shadow=shadow)
    if all(hasattr(leaf, f) for f in ("data", "scale", "dim")):
        return BinaryEmbeddingQTensor(data=as_tensor(leaf.data, device),
                                      scale=as_tensor(leaf.scale, device), grad_shadow=shadow,
                                      dim=int(leaf.dim))
    return None


def _is_record(leaf: Any) -> bool:
    """A quantized record (the JAX package's or the port's), not an array
    or a subtree."""
    return dataclasses.is_dataclass(leaf) and hasattr(leaf, "grad_shadow")


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
        if isinstance(target, (QuantLayer, MBWQLinear)) and _is_record(val):
            # a record in the layer's place (an MoE expert's gate, up, down)
            _load_qweight(target, val, where, device)
            continue
        if isinstance(val, (tuple, list)):
            # a tuple of subtrees (MoE experts) fills a ModuleList in order
            if not isinstance(target, nn.ModuleList) or len(target) != len(val):
                raise KeyError(f"{where}: a sequence of {len(val)} needs a ModuleList of as many "
                               f"in {type(module).__name__}")
            for i, (sub, subtree) in enumerate(zip(target, val)):
                _load_into(sub, subtree, f"{where}/{i}", device)
            continue
        if isinstance(val, Mapping):
            if not isinstance(target, nn.Module):
                raise KeyError(f"{where}: no such submodule in {type(module).__name__}")
            _load_into(target, val, where, device)
            continue
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"{where}: no such tensor in {type(module).__name__}")
        src = as_tensor(val, device)
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError(f"{where}: shape {tuple(src.shape)} != {tuple(target.shape)}")
        if not target.is_meta:
            target.copy_(src)
        elif key in module._parameters:
            module._parameters[key] = nn.Parameter(src.to(target.dtype),
                                                   requires_grad=target.requires_grad)
        else:
            module._buffers[key] = src.to(target.dtype)


@torch.no_grad()
def load_jax_params(model: nn.Module, tree: Mapping[str, Any], device=None) -> nn.Module:
    """Copy the JAX package's parameters (Llama, ``QuantMLP``,
    ``QuantConvNet``, the QAT layers) into the port's model.

    Flax names map onto the port's modules one to one:
    ``layer_{i}/attn/qkv_proj/qweight``, ``layer_{i}/input_norm/weight``,
    ``embed`` (or ``embed/{data,scale}`` with ``quantize_embed``),
    ``final_norm/weight``, ``lm_head/qweight``, ``Dense_0/kernel``,
    ``BinaryLinear_0/scale_a``, ``qconv_0/qweight``, ``LayerNorm_1/scale``,
    ... .  An MoE layer's ``mlp/router`` is a tensor and ``mlp/experts`` a
    tuple of ``{"gate", "up", "down"}`` dicts of records (no ``qweight``
    key), as the JAX package's ``QuantMoEMLP`` holds them.  The port's
    ``Dense``, ``Conv`` and ``LayerNorm`` keep flax's layouts (kernels
    ``(in, out)`` and HWIO), so fp leaves copy as they are.  A quantized
    weight (an MPQ record, an MBWQ record with its segments, ``q_perm``,
    ``block_perm``, ``perm_block`` and ``channel_scale``, a binary, IntQ or
    binary-embedding record, uint32 words as int32) keeps its layout and
    regime (TPU layouts included) until :func:`prepare_params_for_cuda`
    converts it; a record that carries a ``grad_shadow`` (a tree after the
    JAX package's ``prepare_for_training``) gives its layer that shadow, of
    the port's full shape for a binary conv.

    ``device`` defaults to the model's.  A skeleton built on the ``meta``
    device (``LlamaModel(cfg, device="meta")``) takes the tree's tensors on
    ``device`` in place of its own, and every tensor must be given: one
    left on ``meta`` raises.  Returns the model."""
    if "params" in tree:
        # flax variables: the other collections (an MoE model's sown
        # ``losses``) hold no parameters
        tree = tree["params"]
    if device is None:
        device = next(itertools.chain(model.buffers(), model.parameters())).device
    device = torch.device(device)
    _load_into(model, tree, "", device)
    if getattr(model, "device", None) == torch.device("meta"):
        model.device = device
    left = [name for name, t in itertools.chain(model.named_parameters(), model.named_buffers())
            if t.is_meta]
    if left:
        raise ValueError(f"the tree gave no value for {left}")
    return model


def params_tree(model: nn.Module) -> Dict[str, Any]:
    """The model's parameters as the JAX package's flax tree, the inverse of
    :func:`load_jax_params`: nested dicts by flax path, each quantized
    layer's weight as its record under ``qweight`` (MBWQ segments inside
    it), MoE experts as a tuple of ``{"gate", "up", "down"}`` records, every
    other parameter and buffer as a tensor (no copies)."""
    if isinstance(model, MoEExpert):
        return model.records()
    out: Dict[str, Any] = {}
    skip = set()
    if isinstance(model, (QuantLayer, MBWQLinear)):
        out["qweight"] = model.qweight
        skip = {"grad_shadow", "segments", "q_perm", "channel_scale", "block_perm"}
        skip |= set(getattr(model, "_BUFFERS", ()))
    for name, t in itertools.chain(model.named_parameters(recurse=False),
                                   model.named_buffers(recurse=False)):
        if name not in skip:
            out[name] = t.detach()
    for name, child in model.named_children():
        if name in skip:
            continue
        if isinstance(child, nn.ModuleList):  # MoE experts
            sub = tuple(params_tree(c) for c in child)
        else:
            sub = params_tree(child)
        if sub:
            out[name] = sub
    return out


@torch.no_grad()
def load_jax_diode_state(optimizer, state: Any) -> None:
    """Copy the JAX package's ``DiodeState`` (after ``tree_map(np.asarray,
    ...)``: ``step`` and ``leaf_states``, a tree of the parameters' paths
    holding ``{"exp_avg_l", "exp_avg_s"}`` dicts) into the port's
    ``DiodeMix``: the step count and every moment, by the flax path of
    its parameter or quantized layer (a MoE layer's tuple of experts walked
    as ``experts.<i>``, the names ``load_jax_params`` gives them).  The
    binary regimes' random initial ``exp_avg_s`` decides their first flips,
    so a run held against the JAX package starts from its moments.  Under
    fsdp (``DiodeMix(mesh=)``) each whole moment is cut to this rank's
    share (``DiodeMix.moment_split``).  GaLore states are not carried."""
    tree = state.leaf_states
    if set(tree) == {"params"}:
        tree = tree["params"]
    found = {}

    def walk(node, path):
        if isinstance(node, Mapping) and "exp_avg_s" in node:
            # a quantized layer's state is keyed by its module, others by parameter
            found[".".join(path[:-1] if path[-1] == "qweight" else path)] = node
            return
        items = enumerate(node) if isinstance(node, (tuple, list)) else node.items()
        for key, val in items:
            walk(val, path + (str(key),))

    walk(tree, ())
    if set(found) != set(optimizer.state):
        raise ValueError(f"DiodeState leaves {sorted(found)} != the optimizer's "
                         f"{sorted(optimizer.state)}")
    for name, moments in found.items():
        mine = optimizer.state[name]
        for key in ("exp_avg_l", "exp_avg_s"):
            if key in moments:
                src = as_tensor(moments[key], mine[key].device)
                split = optimizer.moment_split(name)
                if split is not None and tuple(src.shape) != tuple(mine[key].shape):
                    src = src.narrow(split[0], split[1], split[2] - split[1])
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
            k_pool=as_tensor(c.k_pool, device),
            v_pool=as_tensor(c.v_pool, device),
            k_scale=as_tensor(c.k_scale, device),
            v_scale=as_tensor(c.v_scale, device),
            page_table=as_tensor(c.page_table, device),
            kv_heads=int(c.kv_heads),
        )
        for c in caches
    ]
