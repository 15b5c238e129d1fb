"""Checkpoint save and load of a model's parameters, without Orbax.

The counterpart of ``bitorch_engine_tpu/utils/checkpoint.py``.  A checkpoint
is a directory of two files:

* ``params.safetensors``: every tensor of the model's flax-style parameter
  tree (``utils.convert.params_tree``) under its path, a record's fields
  below it (``layer_0/attn/q_proj/qweight/packed``, an MBWQ record's
  ``.../qweight/segments/0/scales``);
* ``qtensor_spec.json``: the tree's structure in the JAX package's schema
  (``_spec_of``): ``{"__qtensor__": class, "fields": ...}`` per record, its
  static fields as ``{"__static__": value}``, ``{"__dict__": ...}``,
  ``{"__seq__": [...], "tuple": true}``, ``{"__none__": true}`` and
  ``{"__array__": {"shape", "dtype"}}`` with numpy's dtype names.

:func:`load_checkpoint` needs no template: it rebuilds the tree, records
included, from the spec, and ``load_jax_params(model, load_checkpoint(path))``
restores a model (a skeleton built on the ``meta`` device included).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import torch
from torch import nn

from .. import qtensor as qt_mod
from .convert import inference_record, params_tree
from .ingest import load_safetensors, save_safetensors

_SPEC_NAME = "qtensor_spec.json"
_TENSORS_NAME = "params.safetensors"

# the records restorable by name
_QT_REGISTRY = {
    name: obj for name, obj in vars(qt_mod).items()
    if isinstance(obj, type) and dataclasses.is_dataclass(obj)
}


def _is_node(field: dataclasses.Field) -> bool:
    """A record field that holds tensors (a pytree node in the JAX package;
    ``None`` there is an empty node, not a static value)."""
    return "Tensor" in str(field.type)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _spec_of(obj, path: str, flat: Dict[str, torch.Tensor]) -> Any:
    """Tree → JSON-able spec; each tensor goes into ``flat`` by its path."""
    if obj is None:
        return {"__none__": True}
    if type(obj) in _QT_REGISTRY.values():
        fields = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            fields[f.name] = (_spec_of(v, f"{path}/{f.name}", flat) if _is_node(f)
                              else {"__static__": v})
        return {"__qtensor__": type(obj).__name__, "fields": fields}
    if isinstance(obj, dict):
        return {"__dict__": {k: _spec_of(v, f"{path}/{k}" if path else k, flat)
                             for k, v in obj.items()}}
    if isinstance(obj, (tuple, list)):
        return {"__seq__": [_spec_of(v, f"{path}/{i}", flat) for i, v in enumerate(obj)],
                "tuple": isinstance(obj, tuple)}
    if isinstance(obj, torch.Tensor):
        flat[path] = obj
        return {"__array__": {"shape": list(obj.shape), "dtype": _dtype_name(obj.dtype)}}
    return {"__static__": obj}


def _tree_of(spec, path: str, flat: Dict[str, torch.Tensor]) -> Any:
    """Spec + the saved tensors → the tree (records rebuilt, CPU tensors)."""
    if "__none__" in spec:
        return None
    if "__qtensor__" in spec:
        cls = _QT_REGISTRY[spec["__qtensor__"]]
        kwargs = {name: sub["__static__"] if "__static__" in sub
                  else _tree_of(sub, f"{path}/{name}", flat)
                  for name, sub in spec["fields"].items()}
        return cls(**kwargs)
    if "__dict__" in spec:
        return {k: _tree_of(v, f"{path}/{k}" if path else k, flat)
                for k, v in spec["__dict__"].items()}
    if "__seq__" in spec:
        seq = [_tree_of(v, f"{path}/{i}", flat) for i, v in enumerate(spec["__seq__"])]
        return tuple(seq) if spec.get("tuple") else seq
    if "__array__" in spec:
        t = flat[path]
        a = spec["__array__"]
        if list(t.shape) != a["shape"] or _dtype_name(t.dtype) != a["dtype"]:
            raise ValueError(f"{path}: saved {tuple(t.shape)} {t.dtype}, spec says {a}")
        return t
    return spec["__static__"]


def _packed(tree):
    """The tree as ``prepare_for_inference`` leaves a model: each record as
    :func:`~.convert.inference_record` makes it."""
    if isinstance(tree, dict):
        return {k: _packed(v) for k, v in tree.items()}
    if isinstance(tree, tuple):  # MoE experts
        return tuple(_packed(v) for v in tree)
    if dataclasses.is_dataclass(tree) and hasattr(tree, "grad_shadow"):
        return inference_record(tree)
    return tree


def save_checkpoint(path: str, model: nn.Module, pack: bool = True) -> None:
    """Save ``model``'s parameter tree into the directory ``path`` (made if
    missing, its two files overwritten).  ``pack=True`` saves what
    ``prepare_for_inference`` would leave (the model itself is not
    changed): grad shadows dropped, binary linears' weights packed."""
    tree = {"params": params_tree(model)}
    if pack:
        tree = _packed(tree)
    flat: Dict[str, torch.Tensor] = {}
    spec = _spec_of(tree, "", flat)
    os.makedirs(path, exist_ok=True)
    save_safetensors(os.path.join(path, _TENSORS_NAME), flat)
    with open(os.path.join(path, _SPEC_NAME), "w") as f:
        json.dump(spec, f)


def load_checkpoint(path: str) -> Any:
    """The saved tree (``{"params": ...}``, records with CPU tensors that map
    the file), rebuilt from ``qtensor_spec.json`` with no template: what
    ``utils.convert.load_jax_params`` takes."""
    spec_path = os.path.join(path, _SPEC_NAME)
    if not os.path.exists(spec_path):
        raise FileNotFoundError(f"no {_SPEC_NAME} in {path}: not a checkpoint of this format")
    with open(spec_path) as f:
        spec = json.load(f)
    return _tree_of(spec, "", load_safetensors(os.path.join(path, _TENSORS_NAME)))
