"""Operations and bytes that the inputs need, from the configuration's shapes.

What the work needs, whatever implements it: a routed model's tokens count
their top-k experts only (not the drop-free capacity the program runs),
prompts count their true lengths (not padded buckets), causal attention
counts the keys each query sees (at most its layer's window), and the head
counts the positions whose logits are used.  A matmul of ``(m, k) @ (k,
n)`` is ``2 m k n`` operations.  Bytes count each packed weight, its scales
and zeros once a forward, so a kernel's roofline is set by the least memory
traffic its inputs allow.  Every count sums over the layers, each by its
own attention window and MLP.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Mlp:
    """One layer's MLP: a dense SwiGLU of ``width``, or ``experts`` routed
    SwiGLU experts of ``width`` each (``top_k`` a token) beside ``shared``
    experts of ``shared_width`` that every token runs."""
    width: int
    experts: int = 0  # 0: dense
    top_k: int = 0
    shared: int = 0
    shared_width: int = 0


@dataclasses.dataclass(frozen=True)
class Shape:
    """A model's shapes.  ``mlps``: each layer's MLP.  ``windows``: each
    layer's attention window (the keys a query sees, itself included),
    ``None`` for full causal attention; empty, every layer full.
    ``head_dim`` 0 is ``hidden // heads``."""
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    vocab: int
    mlps: Tuple[Mlp, ...]
    w_bit: int = 4
    group_size: int = 128
    head_dim: int = 0
    windows: Tuple[Optional[int], ...] = ()

    def __post_init__(self):
        if not self.head_dim:
            object.__setattr__(self, "head_dim", self.hidden // self.heads)
        if not self.windows:
            object.__setattr__(self, "windows", (None,) * self.layers)
        if len(self.windows) != self.layers or len(self.mlps) != self.layers:
            raise ValueError(f"{len(self.windows)} windows and {len(self.mlps)} MLPs for "
                             f"{self.layers} layers")

    @property
    def routed_layers(self) -> int:
        """How many layers route their tokens to experts."""
        return sum(m.experts > 0 for m in self.mlps)


def llama_shape(cfg: Dict[str, Any]) -> Shape:
    """The Llama family's shape: every layer full causal attention and one
    MLP, read from the Hugging Face keys."""
    q = cfg.get("quantization_config", {})
    mlp = Mlp(cfg["intermediate_size"], cfg.get("num_local_experts", 0),
              cfg.get("num_experts_per_tok", 0))
    return Shape(
        hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"],
        vocab=cfg["vocab_size"], mlps=(mlp,) * cfg["num_hidden_layers"],
        w_bit=q.get("bits", 4), group_size=q.get("group_size", 128),
    )


def attn_proj_params(s: Shape) -> int:
    """q, k, v and o of one layer."""
    return s.hidden * (s.heads + 2 * s.kv_heads) * s.head_dim + s.heads * s.head_dim * s.hidden


def mlp_params(s: Shape, routed: bool = True, layer: int = 0) -> int:
    """The SwiGLU parameters one token needs in layer ``layer``: its top-k
    experts, the shared ones and the router (``routed``), or every
    expert, or the dense MLP."""
    m = s.mlps[layer]
    one = 3 * s.hidden * m.width
    if not m.experts:
        return one
    shared = m.shared * 3 * s.hidden * m.shared_width
    return (m.top_k if routed else m.experts) * one + shared + s.hidden * m.experts


def layer_params(s: Shape, routed: bool = True, layer: int = 0) -> int:
    return attn_proj_params(s) + mlp_params(s, routed, layer)


def model_layer_params(s: Shape, routed: bool = True) -> int:
    """``layer_params`` summed over every layer."""
    return sum(layer_params(s, routed, i) for i in range(s.layers))


def head_params(s: Shape) -> int:
    return s.hidden * s.vocab


def token_matmul_flops(s: Shape) -> float:
    """Matmul operations of one token through every layer (no head)."""
    return 2.0 * model_layer_params(s)


def head_flops(s: Shape) -> float:
    return 2.0 * head_params(s)


def prompt_keys(length: int, window: Optional[int]) -> int:
    """Keys the queries of a causal prompt see in all: query ``p`` sees ``p
    + 1``, or ``window`` once ``p`` reaches it."""
    if window is None or window >= length:
        return length * (length + 1) // 2
    return window * (window + 1) // 2 + (length - window) * window


def attn_flops_prompt(s: Shape, length: int) -> float:
    """Causal attention over a whole prompt: two products (scores,
    context) of ``2 · heads · head_dim`` a key each query sees."""
    return 4.0 * s.heads * s.head_dim * sum(prompt_keys(length, w) for w in s.windows)


def attn_flops_token(s: Shape, context: int) -> float:
    """One token attending ``context`` keys (itself included), or its
    layer's window of them."""
    return 4.0 * s.heads * s.head_dim * sum(context if w is None else min(context, w)
                                            for w in s.windows)


def weight_bytes_per_forward(s: Shape) -> float:
    """Packed codes plus bf16 scales and zeros of every layer's weights a
    forward reads (every expert: a chunk's tokens route to all of them;
    the f32 router is not counted)."""
    params = model_layer_params(s, routed=False) - sum(s.hidden * m.experts for m in s.mlps)
    per_param = s.w_bit / 8 + 2 * 2 / s.group_size
    return params * per_param


def train_step_flops(s: Shape, batch: int, seq: int) -> Dict[str, float]:
    """A train step's model operations: ``6 ×`` matmul parameters (every
    layer and the head) × tokens, causal attention's forward (2 products)
    and backward (5 products); remat's recomputation is not counted."""
    tokens = batch * seq
    matmul = 6.0 * (model_layer_params(s) + head_params(s)) * tokens
    fwd = batch * attn_flops_prompt(s, seq)
    return {"matmul": matmul, "attention_forward": fwd, "attention_backward": 2.5 * fwd,
            "total": matmul + 3.5 * fwd}
