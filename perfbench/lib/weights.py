"""Seeded weights, made by the benchmark on the device, in the forms users bring.

Both sides read these arrays: the program through its loading entry point
(``utils.convert.load_jax_params`` into a ``meta`` skeleton), the
reference by unpacking them itself.

The seeding rule, which every architecture's weights keep (``archs/``):
one generator a layer, from the seed and the layer's index
(``generator(seed, i, device)``; the embedding, the head and the final
norm each from their own salt), drawn in a few large calls: every code
word of a layer in one draw, every scale in another.  So the reference
can make any layer again, on its own, after the program's state is freed.
The public helpers are the blocks a new architecture builds its layers
from: ``generator``, ``sym_records``, ``gptq_records``, ``norms``,
``pack_cols``, and ``embedding``, ``head`` and ``final_norm``.  These three
read ``vocab_size`` and ``hidden_size``, and of the ``port`` section
``quantize_embed`` (``embedding``: an int8 table, else bf16) and
``head_pad_to`` (``head``: the vocabulary padded to a multiple of it).
``layer`` is the Llama family's.

Forms (``quantization_config.form`` of a configuration file):

* ``sym_w4``: the serving form.  Random code words (every 4-bit code
  uniform on 0..15), group scales of bf16 values around ``rms / 4.61``
  (the rms of ``q − 7.5`` over uniform codes), subtractive zeros of the
  bf16 value nearest ``7.5 · s``: ``w = q · s − z``, centred on the codes'
  mean (zeros of ``8 · s`` give every weight a common ``−s / 2``, and the
  model a common direction that its outputs collapse onto).  Scales and
  zeros are bf16 values, so the port's bf16 metadata holds them exactly.
  A fused q|k|v; MoE experts each with gate, up and down; an f32 router
  ``normal × 0.02``; an int8 embedding with bf16-valued per-row scales; a
  head padded to ``head_pad_to`` columns.
* ``gptq_act_order``: an AutoGPTQ ``desc_act`` export as the port holds it
  after ingest: packed codes in stored order (group ``r // group_size``
  for stored row ``r``), fp16-valued scales of about ``2 / sqrt(K)`` over
  the code range, integer zero points of 7 or 8 (centred on the codes'
  mean, ``chip_smoke.gptq_projection(centered=True)``) packed as ``zero -
  1`` along N, and ``q_perm``: stored row ``r`` is logical row
  ``q_perm[r]``.  The untied head is symmetric w4 g128 as above (the
  port's loader quantizes an fp head so), the embedding bf16.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from .flops import llama_shape

# salts of the generators: a layer's own, then the model's other tensors
_EMBED, _HEAD, _FINAL = 1_000_001, 1_000_002, 1_000_003


def generator(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2**63))
    return g


def _words(g, total: int, device) -> torch.Tensor:
    """``total`` random int32 words (eight uniform 4-bit codes each)."""
    return torch.randint(-(2**31), 2**31, (total,), generator=g, device=device,
                         dtype=torch.int64).to(torch.int32)


def pack_cols(z: torch.Tensor, w_bit: int = 4) -> torch.Tensor:
    """Integer zeros ``(G, N)`` in ``[1, 2^b]`` → int32 ``(G, N·b/32)``
    holding ``zero - 1``, value ``j`` of a word at bit ``j · b`` (GPTQ)."""
    ppw = 32 // w_bit
    g, n = z.shape
    vals = (z.to(torch.int64) - 1).reshape(g, n // ppw, ppw)
    shifts = torch.arange(ppw, device=z.device, dtype=torch.int64) * w_bit
    words = (vals << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def sym_records(g, shapes: List[Tuple[int, int]], rms: float, group: int, device
                ) -> List[Dict[str, torch.Tensor]]:
    """Symmetric w4 records of the ``(K, N)`` shapes: one draw of words, one
    of scales for all of them."""
    n_words = [k // 8 * n for k, n in shapes]
    n_scales = [k // group * n for k, n in shapes]
    words = _words(g, sum(n_words), device)
    z = torch.randn(sum(n_scales), generator=g, device=device)
    scales = (rms / 4.61 * torch.exp(0.2 * z)).to(torch.bfloat16).float()
    zeros = (7.5 * scales).to(torch.bfloat16).float()
    out, w0, s0 = [], 0, 0
    for (k, n), nw, ns in zip(shapes, n_words, n_scales):
        s = scales[s0 : s0 + ns].view(k // group, n)
        zs = zeros[s0 : s0 + ns].view(k // group, n)
        out.append({"packed": words[w0 : w0 + nw].view(k // 8, n), "scales": s, "zeros": zs})
        w0, s0 = w0 + nw, s0 + ns
    return out


def gptq_records(g, shapes: List[Tuple[int, int]], group: int, device
                 ) -> List[Dict[str, torch.Tensor]]:
    """Asym act-order w4 records (see the module's notes)."""
    n_words = [k // 8 * n for k, n in shapes]
    n_groups = [k // group * n for k, n in shapes]
    words = _words(g, sum(n_words), device)
    u = torch.rand(sum(n_groups), generator=g, device=device)
    zi = torch.randint(7, 9, (sum(n_groups),), generator=g, device=device, dtype=torch.int32)
    out, w0, s0 = [], 0, 0
    for (k, n), nw, ng in zip(shapes, n_words, n_groups):
        step = 2.0 / k**0.5 / 16
        s = ((0.5 + u[s0 : s0 + ng].view(k // group, n)) * step).to(torch.float16).float()
        out.append({
            "packed": words[w0 : w0 + nw].view(k // 8, n), "scales": s,
            "zeros": pack_cols(zi[s0 : s0 + ng].view(k // group, n)),
            "q_perm": torch.randperm(k, generator=g, device=device).to(torch.int32),
        })
        w0, s0 = w0 + nw, s0 + ng
    return out


def norms(g, hidden: int, count: int, device) -> List[torch.Tensor]:
    w = 1.0 + 0.05 * torch.randn(count, hidden, generator=g, device=device)
    return list(w.unbind(0))


def layer(cfg: Dict[str, Any], seed: int, i: int, device) -> Dict[str, Any]:
    """Layer ``i``'s arrays: ``attn`` (``qkv``, ``o`` for the serving form;
    ``q``, ``k``, ``v``, ``o`` for gptq), ``mlp`` (``gate``, ``up``,
    ``down``) or ``experts`` (a list of such) and ``router``, and the two
    norms."""
    s = llama_shape(cfg)
    form = cfg["quantization_config"]["form"]
    init = cfg.get("init", {})
    g = generator(seed, i, device)
    h, hd, gs, m = s.hidden, s.head_dim, s.group_size, s.mlps[0]
    out: Dict[str, Any] = {}
    out["input_norm"], out["post_attn_norm"] = norms(g, h, 2, device)
    mlp_shapes = [(h, m.width), (h, m.width), (m.width, h)]
    if form == "sym_w4":
        n_mlp = max(1, m.experts)
        rms, out_rms = init.get("rms", 0.02), init.get("out_rms", 0.02)
        recs = sym_records(g, [(h, (s.heads + 2 * s.kv_heads) * hd)] + mlp_shapes[:2] * n_mlp,
                           rms, gs, device)
        outs = sym_records(g, [(s.heads * hd, h)] + mlp_shapes[2:] * n_mlp, out_rms, gs, device)
        out["attn"] = {"qkv": recs[0], "o": outs[0]}
        mlps = [{"gate": recs[1 + 2 * e], "up": recs[2 + 2 * e], "down": outs[1 + e]}
                for e in range(n_mlp)]
    elif form == "gptq_act_order":
        attn = [(h, s.heads * hd), (h, s.kv_heads * hd), (h, s.kv_heads * hd), (s.heads * hd, h)]
        recs = gptq_records(g, attn + mlp_shapes, gs, device)
        out["attn"] = dict(zip(("q", "k", "v", "o"), recs[:4]))
        mlps = [dict(zip(("gate", "up", "down"), recs[4:7]))]
    else:
        raise ValueError(f"unknown weight form {form!r}")
    if m.experts:
        out["experts"] = mlps
        out["router"] = (torch.randn(h, m.experts, generator=g, device=device)
                         * init.get("router_std", 0.02))
    else:
        out["mlp"] = mlps[0]
    return out


def embedding(cfg: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    """``{"data", "scale"}`` (int8 table, bf16-valued f32 row scales) for a
    quantized embedding, ``{"table"}`` (bf16) otherwise."""
    vocab, hidden = cfg["vocab_size"], cfg["hidden_size"]
    g = generator(seed, _EMBED, device)
    if cfg["port"].get("quantize_embed"):
        data = torch.randint(-127, 128, (vocab, hidden), generator=g, device=device,
                             dtype=torch.int16).to(torch.int8)
        z = torch.randn(vocab, generator=g, device=device)
        scale = (0.02 / 73.6 * torch.exp(0.1 * z)).to(torch.bfloat16).float()
        return {"data": data, "scale": scale}
    table = torch.randn(vocab, hidden, generator=g, device=device) * 0.02
    return {"table": table.to(torch.bfloat16)}


def head(cfg: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    """The symmetric w4 g128 head ``(hidden, vocab padded to head_pad_to)``."""
    vocab, pad = cfg["vocab_size"], cfg["port"].get("head_pad_to", 0)
    n = -(-vocab // pad) * pad if pad else vocab
    return sym_records(generator(seed, _HEAD, device), [(cfg["hidden_size"], n)], 0.02, 128,
                       device)[0]


def final_norm(cfg: Dict[str, Any], seed: int, device) -> torch.Tensor:
    return norms(generator(seed, _FINAL, device), cfg["hidden_size"], 1, device)[0]
