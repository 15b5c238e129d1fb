"""The system under test: the port's model, loaded with the benchmark's weights.

The configuration's architecture module (``archs/<arch>.py``) gives the
port's model config and the flax-named tree of the benchmark's seeded
weights; for the Llama family they are ``port_config`` and ``tree`` here:
the configuration file's ``port`` section names the port's factory in
``models.llama`` and the settings it is run with, and the weights are
``weights.py``'s.  ``build`` hands the tree to the port's loading entry point
(``utils.convert.load_jax_params`` into a ``LlamaModel`` skeleton on the
``meta`` device, the path ``models.llama_loader`` takes for checkpoints),
then brings the model to the form it is served or trained in
(``prepare_params_for_cuda`` with bf16 metadata, as ``chip_smoke.py``
serves; ``prepare_for_training``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from . import weights
from .bench import load_arch
from .flops import llama_shape


def port_config(cfg: Dict[str, Any], max_seq_len: int):
    """The port's ``LlamaConfig`` of a Llama-family configuration file."""
    from bitorch_engine_tpu_torch.models import llama

    port = dict(cfg["port"])
    factory = getattr(llama, port.pop("factory"))
    port.pop("prepare", None)
    s = llama_shape(cfg)
    m = s.mlps[0]
    if m.experts:
        port.update(moe_num_experts=m.experts, moe_top_k=m.top_k)
    return factory(
        num_layers=s.layers, vocab_size=s.vocab, hidden_size=s.hidden,
        intermediate_size=m.width, num_heads=s.heads, num_kv_heads=s.kv_heads,
        rope_theta=float(cfg["rope_theta"]), rms_eps=float(cfg["rms_norm_eps"]),
        w_bit=s.w_bit, group_size=s.group_size, max_seq_len=max_seq_len,
        dtype=torch.bfloat16, **port,
    )


@dataclasses.dataclass
class Record:
    """A w4 record in the fields the loader reads (``utils.convert._mpq``)."""
    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor
    group_size: int
    asym: bool
    q_perm: Optional[torch.Tensor] = None
    w_bit: int = 4
    layout: str = "gptq"
    grad_shadow: Optional[torch.Tensor] = None


def _record(rec: Dict[str, torch.Tensor], asym: bool) -> Record:
    return Record(rec["packed"], rec["scales"], rec["zeros"],
                  rec["packed"].shape[0] * 8 // rec["scales"].shape[0], asym, rec.get("q_perm"))


def _proj(rec, asym):
    return {"qweight": _record(rec, asym)}


def tree(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """A Llama-family model's parameters, flax-named, drawn from ``seed``."""
    s = llama_shape(cfg)
    asym = cfg["quantization_config"]["form"] == "gptq_act_order"
    out: Dict[str, Any] = {}
    for i in range(s.layers):
        w = weights.layer(cfg, seed, i, device)
        names = {"qkv": "qkv_proj", "q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj"}
        attn = {names[k]: _proj(v, asym) for k, v in w["attn"].items()}
        if "experts" in w:
            mlp = {"router": w["router"],
                   "experts": tuple({k: _record(v, False) for k, v in e.items()}
                                    for e in w["experts"])}
        else:
            mlp = {f"{k}_proj": _proj(v, asym) for k, v in w["mlp"].items()}
        out[f"layer_{i}"] = {"attn": attn, "mlp": mlp, "input_norm": {"weight": w["input_norm"]},
                             "post_attn_norm": {"weight": w["post_attn_norm"]}}
    emb = weights.embedding(cfg, seed, device)
    out["embed"] = emb["table"] if "table" in emb else emb
    out["lm_head"] = _proj(weights.head(cfg, seed, device), False)
    out["final_norm"] = {"weight": weights.final_norm(cfg, seed, device)}
    return out


@torch.no_grad()
def build(cfg: Dict[str, Any], seed: int, device, max_seq_len: int, arch=None):
    """The port's model of ``cfg`` holding the weights of ``seed``, on
    ``device``, in the form the configuration runs in: the config and the
    weights as its architecture module (``arch``, else the one ``cfg``
    names) gives them."""
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, fuse_llama_params
    from bitorch_engine_tpu_torch.utils.convert import (
        load_jax_params, prepare_for_training, prepare_params_for_cuda,
    )

    arch = arch or load_arch(cfg)
    lcfg = arch.port_config(cfg, max_seq_len)
    # a dense MLP's gate and up load apart, then fuse as the configuration asks
    fuse_mlp = lcfg.fuse_gate_up and not lcfg.moe_num_experts
    model = LlamaModel(lcfg.replace(fuse_gate_up=lcfg.fuse_gate_up and not fuse_mlp), device="meta")
    load_jax_params(model, arch.tree(cfg, seed, device), device=device)
    if fuse_mlp:
        fuse_llama_params(model, fuse_qkv=False, fuse_gate_up=True)
    prepare = cfg["port"].get("prepare")
    if prepare == "serve_bf16_meta":
        prepare_params_for_cuda(model, meta_dtype=torch.bfloat16)
    elif prepare == "train":
        prepare_for_training(model)
    elif prepare is not None:
        raise ValueError(f"unknown preparation {prepare!r}")
    return model
