"""Sampling and the simple batched generation loop (the counterpart of the
first half of ``models/generate.py``; ``ContinuousBatcher`` comes with the
serving slice)."""

from __future__ import annotations

from typing import Optional

import torch

from .llama import LlamaModel, decode_step, init_kv_caches


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
) -> torch.Tensor:
    """Greedy (temperature 0) or top-k temperature sampling; logits (b, V).

    Sampling draws from ``generator``, so it gives other tokens than the JAX
    package's PRNG for the same seed; greedy tokens are the same."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    model: LlamaModel,
    prompt: torch.Tensor,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    eos_id: Optional[int] = None,
    seed: int = 0,
    max_len: Optional[int] = None,
) -> torch.Tensor:
    """Prefill the prompt, then decode; ``prompt`` int ``(b, plen)`` →
    ``(b, plen + max_new_tokens)`` (sequences past EOS repeat EOS).

    Both phases read the whole cache (no attention window), as the JAX
    package's ``generate`` does."""
    cfg = model.cfg
    prompt = prompt.to(model.device)
    b, plen = prompt.shape
    max_len = max_len or min(cfg.max_seq_len, plen + max_new_tokens)
    caches = init_kv_caches(cfg, b, max_len, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(seed)

    logits, caches = model(prompt, kv_caches=caches, cache_len=0)
    nxt = sample_token(logits[:, -1], gen, temperature)
    out = [prompt, nxt[:, None]]
    finished = torch.zeros(b, dtype=torch.bool, device=model.device)
    for i in range(max_new_tokens - 1):
        logits, caches = decode_step(model, nxt[:, None], caches, plen + i)
        nxt = sample_token(logits, gen, temperature)
        if eos_id is not None:
            finished = finished | (nxt == eos_id)
            nxt = torch.where(finished, eos_id, nxt)
        out.append(nxt[:, None])
    return torch.cat(out, dim=1)
