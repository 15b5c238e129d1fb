"""The plain reference: the configuration's model in float32 PyTorch.

It follows the published Llama / Mistral / Mixtral equations (RMSNorm,
rotate-half RoPE, grouped-query causal attention, SwiGLU, top-k routed
experts with the k gates renormalized) and the forms the configuration
states: symmetric w4 weights ``w = q · s − z`` or GPTQ act-order weights
``w = s · (q − z)`` in stored rows put back by ``q_perm``, each unpacked
here from the benchmark's words; an int8 KV cache where the configuration
says so (each position's and head's key and value rounded to int8 at
``amax / 127`` before any read); an int8 embedding.  No kernel, cache,
batching or padding; TF32 off.  It imports nothing of the program and
reads only the benchmark's arrays (``lib/weights.py``, made again from the
seed).

An MoE layer may be told the experts each token goes to (``routes``: a
program's, logged where it served the tokens).  It then follows them,
with its own router's probabilities for the gates, and reports how far a
followed expert lies below its own top-k (the shortfall of a followed
expert's probability under the k-th best: ``route_gap`` the largest,
with its sum over the rows), which judges the routing by itself: a random model's outputs turn on which
expert wins a near tie, so a comparison of logits that let each side
route alone would read the ties, not the program.

``precision="fp8"`` is the control: the operands of every matmul that the
configuration runs in bf16 rounded to float8 e4m3 (per-row scales for the
left operand, per-column for the right), the step below the bf16 that the
configurations state; the f32 router stays f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..lib import weights
from ..lib.flops import llama_shape

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """int32 ``(K/8, N)`` words → int64 codes ``(K, N)``: value ``j`` of
    word ``r`` is row ``8 r + j``, at bit ``4 j``."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(8, device=packed.device, dtype=torch.int64) * 4
    vals = (words[:, None, :] >> shifts[None, :, None]) & 0xF
    return vals.reshape(-1, packed.shape[1])


def unpack_zero_points(packed: torch.Tensor) -> torch.Tensor:
    """int32 ``(G, N/8)`` → int64 ``(G, N)`` integer zero points (stored ``z - 1``)."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(8, device=packed.device, dtype=torch.int64) * 4
    return ((words[:, :, None] >> shifts) & 0xF).reshape(packed.shape[0], -1) + 1


def dequant(rec: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A record's float32 weight ``(K, N)`` in logical row order."""
    q = unpack_rows(rec["packed"]).double()
    k = q.shape[0]
    g = torch.arange(k, device=q.device) // (k // rec["scales"].shape[0])
    s = rec["scales"].double()[g]
    if "q_perm" in rec:  # gptq asym: s (q - z), stored rows
        z = unpack_zero_points(rec["zeros"]).double()[g]
        w = (s * (q - z)).float()
        out = torch.empty_like(w)
        out[rec["q_perm"].long()] = w
        return out
    return (q * s - rec["zeros"].double()[g]).float()


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    """The matmul of a precision: float32, or the fp8 control."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x (..., k) @ w (k, n)``."""
        if self.fp8:
            x, w = fp8(x, -1), fp8(w, -2)
        return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``x (..., L, h, d)`` at positions ``pos (..., L)``."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d))
    ang = pos.float()[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def int8_round_trip(t: torch.Tensor) -> torch.Tensor:
    """Each (position, head) vector rounded to int8 at ``max(amax, 1e-6) / 127``."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    return torch.clamp(torch.round(t / scale), -127, 127) * scale


def attention(q, k, v, ops: Ops) -> torch.Tensor:
    """Causal grouped-query attention: ``q (..., L, nh, d)``, ``k, v (..., L,
    nkv, d)`` → ``(..., L, nh·d)``."""
    nh, nkv, d = q.shape[-2], k.shape[-2], q.shape[-1]
    k = k.repeat_interleave(nh // nkv, dim=-2)
    v = v.repeat_interleave(nh // nkv, dim=-2)
    qh, kh, vh = (t.transpose(-3, -2) for t in (q, k, v))  # (..., h, L, d)
    sc = ops.mm(qh, kh.transpose(-1, -2)) / math.sqrt(d)
    L = q.shape[-3]
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
    ctx = ops.mm(p, vh).transpose(-3, -2)
    return ctx.reshape(*ctx.shape[:-2], nh * d)


def swiglu(x, gate, up, down, ops: Ops) -> torch.Tensor:
    return ops.mm(F.silu(ops.mm(x, gate)) * ops.mm(x, up), down)


def moe(x: torch.Tensor, w: Dict[str, Any], top_k: int, ops: Ops,
        forced: Optional[torch.Tensor] = None, stats: Optional[Dict[str, Any]] = None
        ) -> torch.Tensor:
    """Top-k routed SwiGLU experts over rows ``x (T, h)``: router softmax in
    f32, the k largest (ties to the lower expert), or the experts
    ``forced`` ``(T, k)``; gates renormalized.  ``stats``: the layer's
    chosen experts (``"routes"``) and the largest ``route_gap``."""
    probs = torch.softmax(x @ w["router"], dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = order.indices[:, :top_k] if forced is None else forced.long()
    if stats is not None:
        kth = order.values[:, top_k - 1]
        short = (kth - probs.gather(1, idx).min(dim=-1).values).clamp_min(0)
        stats["route_gap"] = max(stats.get("route_gap", 0.0), float(short.max()))
        stats["route_short_sum"] = stats.get("route_short_sum", 0.0) + float(short.sum())
        stats["route_rows"] = stats.get("route_rows", 0) + short.numel()
        stats.setdefault("routes", []).append(idx)
    gates = probs.gather(1, idx)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(x)
    for e, ex in enumerate(w["experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        out = swiglu(x[rows], dequant(ex["gate"]), dequant(ex["up"]), dequant(ex["down"]), ops)
        y.index_add_(0, rows, out * gates[rows, slot][:, None])
    return y


def embed(cfg: Dict[str, Any], seed: int, tokens: torch.Tensor, device) -> torch.Tensor:
    e = weights.embedding(cfg, seed, device)
    if "data" in e:
        return e["data"][tokens].float() * e["scale"][tokens][:, None]
    return e["table"][tokens].float()


def attn_block(x, w, pos, cfg, ops: Ops, int8_kv: bool) -> torch.Tensor:
    """One layer's attention on one sequence's rows ``x (L, h)`` (the
    residual not added)."""
    s = llama_shape(cfg)
    hd = s.head_dim
    h = rms_norm(x, w["input_norm"], cfg["rms_norm_eps"])
    a = w["attn"]
    if "qkv" in a:
        qkv = ops.mm(h, dequant(a["qkv"]))
        q, k, v = torch.split(qkv, [s.heads * hd, s.kv_heads * hd, s.kv_heads * hd], dim=-1)
    else:
        q, k, v = (ops.mm(h, dequant(a[n])) for n in ("q", "k", "v"))
    L = x.shape[0]
    q = rope(q.reshape(L, s.heads, hd), pos, cfg["rope_theta"])
    k = rope(k.reshape(L, s.kv_heads, hd), pos, cfg["rope_theta"])
    v = v.reshape(L, s.kv_heads, hd)
    if int8_kv:
        k, v = int8_round_trip(k), int8_round_trip(v)
    return ops.mm(attention(q, k, v, ops), dequant(a["o"]))


@torch.no_grad()
def logits_at(cfg: Dict[str, Any], seed: int, seqs: List[torch.Tensor], wanted: List[torch.Tensor],
              device, precisions=("f32",), routes: Optional[List[torch.Tensor]] = None,
              stats: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict[str, List[torch.Tensor]]:
    """The reference's f32 logits ``(len(wanted[i]), vocab)`` of each token
    sequence ``seqs[i]`` (int64, on ``device``) at positions ``wanted[i]``,
    for each precision, layer by layer over every sequence (each layer's
    weights made again from the seed, one expert at a time).  ``routes``:
    each sequence's ``(layers, len, k)`` experts to follow; ``stats``
    collects each precision's ``route_gap`` and its chosen ``routes``."""
    no_tf32()
    s = llama_shape(cfg)
    int8_kv = cfg["port"].get("kv_cache_dtype") == "int8"
    lens = [len(t) for t in seqs]
    x0 = embed(cfg, seed, torch.cat(seqs), device)
    xs = {p: x0.clone() for p in precisions}
    del x0
    stats = {} if stats is None else stats
    for p in precisions:
        stats.setdefault(p, {})
    for i in range(s.layers):
        w = weights.layer(cfg, seed, i, device)
        for p, x in xs.items():
            ops = Ops(p)
            parts = []
            for xi in torch.split(x, lens):
                pos = torch.arange(len(xi), device=device)
                parts.append(attn_block(xi, w, pos, cfg, ops, int8_kv))
            x = x + torch.cat(parts)
            h = rms_norm(x, w["post_attn_norm"], cfg["rms_norm_eps"])
            if "experts" in w:
                forced = None if routes is None else torch.cat([r[i] for r in routes])
                x = x + moe(h, w, s.mlps[i].top_k, ops, forced, stats[p])
            else:
                m = w["mlp"]
                x = x + swiglu(h, dequant(m["gate"]), dequant(m["up"]), dequant(m["down"]), ops)
            xs[p] = x
        del w
    head = dequant(weights.head(cfg, seed, device))[:, : s.vocab]
    fnorm = weights.final_norm(cfg, seed, device)
    for st in stats.values():
        if "routes" in st:  # per sequence (layers, len, k)
            per_layer = [torch.split(r, lens) for r in st.pop("routes")]
            st["routes"] = [torch.stack([layer[j] for layer in per_layer]) for j in range(len(lens))]
    out: Dict[str, List[torch.Tensor]] = {}
    for p, x in xs.items():
        rows = [xi[idx] for xi, idx in zip(torch.split(x, lens), wanted)]
        ops = Ops(p)
        out[p] = [ops.mm(rms_norm(r, fnorm, cfg["rms_norm_eps"]), head) for r in rows]
    return out


def served_gaps(ref: List[torch.Tensor], tokens: List[List[int]], far: float
                ) -> Dict[str, float]:
    """The widest and the mean gap by which a served token's reference
    logit lies below the reference's best at its position, and
    ``served_far``: how many served tokens lie more than ``far`` logits
    below it (one wrong token is enough to count)."""
    gaps = []
    for r, toks in zip(ref, tokens):
        best = r.max(dim=-1).values
        t = torch.tensor(toks, device=r.device)
        gaps.append(best - r.gather(1, t[:, None])[:, 0])
    g = torch.cat(gaps)
    return {"served_gap": float(g.max()), "served_gap_mean": float(g.mean()),
            "served_far": float((g > far).sum())}
