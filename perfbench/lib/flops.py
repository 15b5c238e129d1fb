"""Operations and bytes that the inputs need, from the configuration's shapes.

What the work needs, whatever implements it: a routed model's tokens count
their top-k experts only (not the drop-free capacity the program runs),
prompts count their true lengths (not padded buckets), causal attention
counts the keys each query sees, and the head counts the positions whose
logits are used.  A matmul of ``(m, k) @ (k, n)`` is ``2 m k n``
operations.  Bytes count each packed weight, its scales and zeros once a
forward, so a kernel's roofline is set by the least memory traffic its
inputs allow.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class Shape:
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    vocab: int
    experts: int = 0  # 0: a dense MLP
    top_k: int = 0
    w_bit: int = 4
    group_size: int = 128

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "Shape":
        q = cfg.get("quantization_config", {})
        return cls(
            hidden=cfg["hidden_size"], intermediate=cfg["intermediate_size"],
            layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
            kv_heads=cfg["num_key_value_heads"], vocab=cfg["vocab_size"],
            experts=cfg.get("num_local_experts", 0), top_k=cfg.get("num_experts_per_tok", 0),
            w_bit=q.get("bits", 4), group_size=q.get("group_size", 128),
        )


def attn_proj_params(s: Shape) -> int:
    """q, k, v and o of one layer."""
    return s.hidden * (s.heads + 2 * s.kv_heads) * s.head_dim + s.heads * s.head_dim * s.hidden


def mlp_params(s: Shape, routed: bool = True) -> int:
    """The SwiGLU parameters one token needs in one layer: its top-k
    experts and the router (``routed``), or every expert, or the dense MLP."""
    one = 3 * s.hidden * s.intermediate
    if not s.experts:
        return one
    return (s.top_k if routed else s.experts) * one + s.hidden * s.experts


def layer_params(s: Shape, routed: bool = True) -> int:
    return attn_proj_params(s) + mlp_params(s, routed)


def head_params(s: Shape) -> int:
    return s.hidden * s.vocab


def token_matmul_flops(s: Shape) -> float:
    """Matmul operations of one token through every layer (no head)."""
    return 2.0 * layer_params(s) * s.layers


def head_flops(s: Shape) -> float:
    return 2.0 * head_params(s)


def attn_flops_prompt(s: Shape, length: int) -> float:
    """Causal attention over a whole prompt: query p sees p + 1 keys, two
    products (scores, context) of ``2 · heads · head_dim`` a key."""
    return s.layers * 4.0 * s.heads * s.head_dim * length * (length + 1) / 2


def attn_flops_token(s: Shape, context: int) -> float:
    """One token attending ``context`` keys (itself included)."""
    return s.layers * 4.0 * s.heads * s.head_dim * context


def weight_bytes_per_forward(s: Shape) -> float:
    """Packed codes plus bf16 scales and zeros of every layer's weights a
    forward reads (every expert: a chunk's tokens route to all of them)."""
    params = layer_params(s, routed=False) - s.hidden * s.experts
    per_param = s.w_bit / 8 + 2 * 2 / s.group_size
    return s.layers * params * per_param


def train_step_flops(s: Shape, batch: int, seq: int) -> Dict[str, float]:
    """A train step's model operations: ``6 ×`` matmul parameters (every
    layer and the head) × tokens, causal attention's forward (2 products)
    and backward (5 products); remat's recomputation is not counted."""
    tokens = batch * seq
    matmul = 6.0 * (s.layers * layer_params(s) + head_params(s)) * tokens
    fwd = batch * attn_flops_prompt(s, seq)
    return {"matmul": matmul, "attention_forward": fwd, "attention_backward": 2.5 * fwd,
            "total": matmul + 3.5 * fwd}
