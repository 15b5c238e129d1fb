"""Llama checkpoints in the HF layout → the port's ``LlamaModel``.

The counterpart of ``bitorch_engine_tpu/models/llama_loader.py``.  HF names
map to the port's (the JAX package's flax paths):

    model.embed_tokens.weight                  → embed (int8 ``embed/{data,scale}``
                                                 with ``quantize_embed``)
    model.layers.{i}.self_attn.{q,k,v,o}_proj  → layer_{i}/attn/{q,k,v,o}_proj
    model.layers.{i}.mlp.{gate,up,down}_proj   → layer_{i}/mlp/{gate,up,down}_proj
    model.layers.{i}.input_layernorm.weight    → layer_{i}/input_norm/weight
    model.layers.{i}.post_attention_layernorm  → layer_{i}/post_attn_norm/weight
    model.norm.weight                          → final_norm/weight
    lm_head.weight (with ``cfg.head_w_bit``)   → lm_head/qweight (w4 g128, padded
                                                 to ``head_pad_to``; the embedding
                                                 table where the checkpoint ties it)

A projection's ``.qweight`` / ``.qzeros`` / ``.scales`` (/ ``.g_idx``) is
ingested as GPTQ (``utils.ingest.mpq_from_gptq``, act-order canonicalized);
an fp ``.weight`` is quantized round-to-nearest at ``(cfg.w_bit,
cfg.group_size)``.  Each loader builds the model as a skeleton on the ``meta`` device
(shapes only: nothing is drawn or quantized at random) and installs the
weights with ``utils.convert.load_jax_params``; fused configurations are
fused after (``fuse_llama_params``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch

from ..device import DeviceLike, resolve_device
from ..ops.mbwq_linear import quantize_mbwq, strategy_dict
from ..ops.quant import quantize_mpq
from ..utils import ingest
from ..utils.convert import load_jax_params, params_tree
from .llama import LlamaConfig, LlamaModel, fuse_llama_params

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")


def _build_from_tree(tree: Mapping[str, Any], cfg: LlamaConfig, device: torch.device) -> LlamaModel:
    """An unfused ``LlamaModel(cfg)`` skeleton filled from the flax-style
    ``tree`` on ``device``, then fused as ``cfg`` asks."""
    model = LlamaModel(cfg.replace(fuse_qkv=False, fuse_gate_up=False), device="meta")
    load_jax_params(model, tree, device=device)
    if cfg.fuse_qkv or cfg.fuse_gate_up:
        fuse_llama_params(model, cfg.fuse_qkv, cfg.fuse_gate_up)
    return model


def load_llama_params(
    tensors: Mapping[str, Any], cfg: LlamaConfig, dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> LlamaModel:
    """An HF-layout tensor dict (numpy arrays or torch tensors) → a
    ``LlamaModel(cfg)`` on ``device`` (``None`` means ``cuda``) holding its
    weights; biases (Qwen2's q/k/v) and a bf16 embedding in ``dtype``."""
    if cfg.mbwq_strategy is not None:
        raise ValueError("HF checkpoints load into MPQ projections; quantize_llama_params "
                         "builds MBWQ ones from an fp model")
    dev = resolve_device(device)

    def f32(a):
        return ingest.as_tensor(a, dev, torch.float32)

    def proj(prefix: str):
        if prefix + ".qweight" in tensors:
            return {"qweight": ingest.mpq_from_gptq(
                tensors[prefix + ".qweight"], tensors[prefix + ".qzeros"],
                tensors[prefix + ".scales"], tensors.get(prefix + ".g_idx"), device=dev)}
        w = f32(tensors[prefix + ".weight"]).T  # (K, N)
        return {"qweight": quantize_mpq(w, w_bit=cfg.w_bit, group_size=cfg.group_size,
                                        asym=cfg.asym)}

    out: Dict[str, Any] = {}
    for name in tensors:
        m = re.match(r"model\.layers\.(\d+)\.(self_attn|mlp)\.(\w+_proj)\.(qweight|weight)$", name)
        if not m:
            continue
        i, proj_name = int(m.group(1)), m.group(3)
        block = out.setdefault(f"layer_{i}", {}).setdefault(
            "attn" if proj_name in _ATTN else "mlp", {})
        if proj_name in block:
            continue
        prefix = name[: name.rindex(".")]
        entry = proj(prefix)
        bias = tensors.get(prefix + ".bias")
        if bias is not None:
            entry["bias"] = f32(bias).to(dtype)
        block[proj_name] = entry

    def norm(name):
        w = tensors.get(name)
        return {"weight": torch.ones(cfg.hidden_size, device=dev) if w is None else f32(w)}

    for i in range(cfg.num_layers):
        layer = out.get(f"layer_{i}")
        if layer is None:
            raise ValueError(f"missing layer {i} in checkpoint")
        layer["input_norm"] = norm(f"model.layers.{i}.input_layernorm.weight")
        layer["post_attn_norm"] = norm(f"model.layers.{i}.post_attention_layernorm.weight")

    if "model.embed_tokens.weight" not in tensors:
        raise ValueError("missing model.embed_tokens.weight")
    embed = f32(tensors["model.embed_tokens.weight"])
    if cfg.quantize_embed:
        # per-row int8, as LlamaModel's Int8Embedding
        scale = torch.clamp_min(embed.abs().amax(dim=1), 1e-6) / 127.0
        data = torch.clamp(torch.round(embed / scale[:, None]), -127, 127).to(torch.int8)
        out["embed"] = {"data": data, "scale": scale}
    else:
        out["embed"] = embed.to(dtype)
    if cfg.head_w_bit is not None:
        # an untied head (llama3); a tied checkpoint takes the embedding table
        head = tensors.get("lm_head.weight")
        head = (embed if head is None else f32(head)).T  # (hidden, vocab)
        if cfg.head_pad_to:
            n_head = -(-head.shape[1] // cfg.head_pad_to) * cfg.head_pad_to
            head = torch.nn.functional.pad(head, (0, n_head - head.shape[1]))
        out["lm_head"] = {"qweight": quantize_mpq(head, w_bit=cfg.head_w_bit, group_size=128,
                                                  asym=False)}
    del embed
    out["final_norm"] = norm("model.norm.weight")
    return _build_from_tree(out, cfg, dev)


def load_llama_from_safetensors(path: str, cfg: LlamaConfig, dtype: torch.dtype = torch.bfloat16,
                                device: DeviceLike = None) -> LlamaModel:
    """:func:`load_llama_params` of a ``.safetensors`` file (read through a
    mapping of the file, ``utils.ingest.load_safetensors``)."""
    return load_llama_params(ingest.load_safetensors(path), cfg, dtype, device)


@torch.no_grad()
def quantize_llama_params(model_fp: LlamaModel, cfg_q: LlamaConfig,
                          device: DeviceLike = None) -> LlamaModel:
    """An fp ``LlamaModel(quantized=False)`` → ``LlamaModel(cfg_q)`` on
    ``device`` (``None`` means ``cuda``) with each projection kernel
    quantized: MPQ at ``(w_bit, group_size, asym, quant_mid_sym)``, or MBWQ
    by ``cfg_q.mbwq_strategy`` (with ``mbwq_container_bits``).  The same
    trained weights flow into the quantized structure; the embedding, the
    norms and the biases pass through."""
    dev = resolve_device(device)
    if cfg_q.mbwq_strategy is not None:
        strategy = strategy_dict(cfg_q.mbwq_strategy, cfg_q.group_size,
                                 cfg_q.mbwq_container_bits, mid_sym=cfg_q.quant_mid_sym)

        def qz(kernel):
            return quantize_mbwq(kernel.to(dev), strategy)
    else:

        def qz(kernel):
            return quantize_mpq(kernel.to(dev), w_bit=cfg_q.w_bit, group_size=cfg_q.group_size,
                                asym=cfg_q.asym, mid_sym=cfg_q.quant_mid_sym)

    def convert(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict) and set(val) in ({"kernel"}, {"kernel", "bias"}):
                out[key] = {"qweight": qz(val["kernel"]), **{k: v for k, v in val.items()
                                                            if k == "bias"}}
            elif isinstance(val, dict):
                out[key] = convert(val)
            else:
                out[key] = val
        return out

    return _build_from_tree(convert(params_tree(model_fp)), cfg_q, dev)
