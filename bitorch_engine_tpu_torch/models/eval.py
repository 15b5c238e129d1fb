"""Evaluation: perplexity and the quantization-quality gate.

The counterpart of ``bitorch_engine_tpu/models/eval.py``.  Perplexity over
token streams in chunks, the fp-vs-quantized delta on the same tokens, and
the in-repo gate: a small byte-level Llama trained on a deterministic
corpus (``data/tiny_corpus.txt`` expanded by a word-bigram sampler, a copy
of the JAX package's file), quantized in every configuration of the JAX
package's gate, its held-out perplexity against the fp model's.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@torch.no_grad()
def sequence_nll(model, tokens, chunk: int = 1024) -> float:
    """Mean negative log-likelihood (nats a token) of ``tokens`` ``(b, T)``
    under ``model``, in chunks of ``chunk`` predictions (each chunk a fresh
    causal forward)."""
    tokens = torch.as_tensor(tokens).to(model.device)
    t = tokens.shape[1]
    total, count = 0.0, 0
    for s in range(0, t - 1, chunk):
        piece = tokens[:, s : s + chunk + 1]
        if piece.shape[1] < 2:
            break
        logits, _ = model(piece)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = piece[:, 1:].long()
        picked = logp.gather(-1, tgt[..., None])[..., 0]
        total += float(-picked.sum())
        count += tgt.numel()
    return total / max(count, 1)


def perplexity(model, tokens, chunk: int = 1024) -> float:
    return float(np.exp(sequence_nll(model, tokens, chunk)))


def perplexity_delta(model_fp, model_q, tokens) -> dict:
    """fp against quantized on the same tokens: both perplexities and Δ."""
    ppl_fp = perplexity(model_fp, tokens)
    ppl_q = perplexity(model_q, tokens)
    return {"ppl_fp": ppl_fp, "ppl_quant": ppl_q, "delta": ppl_q - ppl_fp,
            "rel_delta": (ppl_q - ppl_fp) / ppl_fp}


def _seed_text() -> str:
    return (pathlib.Path(__file__).parent.parent / "data" / "tiny_corpus.txt").read_text()


def expand_corpus(n_bytes: int, seed: int = 0) -> np.ndarray:
    """A deterministic corpus of ``n_bytes`` (int32 byte values): a
    word-bigram Markov sampler fitted on the seed text, so train and
    held-out streams come from one distribution without sharing text."""
    words = _seed_text().split()
    nxt: dict = {}
    for a, b in zip(words, words[1:]):
        nxt.setdefault(a, []).append(b)
    rng = np.random.default_rng(seed)
    out: list = []
    w = words[0]
    size = 0
    while size < n_bytes:
        out.append(w)
        size += len(w) + 1
        cands = nxt.get(w)
        if not cands:
            w = words[int(rng.integers(0, len(words)))]
        else:
            w = cands[int(rng.integers(0, len(cands)))]
    text = " ".join(out)[:n_bytes]
    return np.frombuffer(text.encode(), dtype=np.uint8).astype(np.int32)


def byte_corpus(split: str = "train", train_bytes: int = 200_000,
                eval_bytes: int = 20_000) -> np.ndarray:
    """The Markov-expanded byte stream; train and eval draw from disjoint
    sampler seeds."""
    if split == "train":
        return expand_corpus(train_bytes, seed=1)
    return expand_corpus(eval_bytes, seed=2)


def train_byte_lm(cfg, steps: int = 300, batch: int = 16, seq_len: int = 128, lr: float = 3e-3,
                  seed: int = 0, device: DeviceLike = None):
    """Train an fp byte-level ``LlamaModel(cfg)`` on the corpus with
    ``torch.optim.AdamW(lr, weight_decay=0.01)`` (optax's ``adamw``
    defaults otherwise), from weights drawn by the model's seeded
    ``torch.Generator``, on batches at offsets drawn from
    ``numpy.random.default_rng(seed)`` as the JAX package draws them.
    Returns ``(model, final_loss)``."""
    from ..training import cross_entropy_loss
    from .llama import LlamaModel

    dev = resolve_device(device)
    model = LlamaModel(cfg, device=dev, seed=seed)
    for p in model.parameters():
        p.requires_grad_(True)
    data = byte_corpus("train")
    rng = np.random.default_rng(seed)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    loss = None
    for _ in range(steps):
        offs = rng.integers(0, len(data) - seq_len - 1, size=batch)
        toks = torch.from_numpy(np.stack([data[o : o + seq_len + 1] for o in offs])).to(dev)
        loss = cross_entropy_loss(model(toks[:, :-1])[0], toks[:, 1:])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    for p in model.parameters():
        p.requires_grad_(False)
    return model, float(loss.detach())


def gate_configs(base: dict) -> dict:
    """The quantized configurations of the JAX package's gate, by name."""
    from .llama import LlamaConfig

    def q(**kw):
        return LlamaConfig(quantized=True, **kw, **base)

    return {
        "w4g64": q(w_bit=4, group_size=64),
        "w2g32": q(w_bit=2, group_size=32),
        "w2g64": q(w_bit=2, group_size=64),
        "w2g128": q(w_bit=2, group_size=128),
        "w2g128_midsym": q(w_bit=2, group_size=128, quant_mid_sym=True),
        "mbwq_2p5_midsym": q(group_size=64, mbwq_strategy=((4, 0.25), (2, 0.75, 128)),
                             quant_mid_sym=True),
        "mbwq_2p5": q(group_size=32, mbwq_strategy=((4, 0.25), (2, 0.75))),
        "mbwq_2p5g64": q(group_size=64, mbwq_strategy=((4, 0.25), (2, 0.75))),
        "mbwq_2p5_w2g128": q(group_size=64, mbwq_strategy=((4, 0.25), (2, 0.75, 128))),
    }


# the arms the gate also runs in the A8 regime (act_bits_map={2: 8})
A8_ARMS = ("mbwq_2p5", "mbwq_2p5g64", "mbwq_2p5_w2g128", "w2g32", "w2g64", "w2g128",
           "w2g128_midsym", "mbwq_2p5_midsym")


def run_ppl_gate(hidden: int = 256, layers: int = 4, steps: int = 300, seq_len: int = 128,
                 seed: int = 0, device: DeviceLike = None) -> dict:
    """Train the byte LM in f32, then measure held-out perplexity, fp
    against every quantized configuration of :func:`gate_configs`, against
    w4g64 with bf16 group metadata (``prepare_params_for_cuda(model,
    torch.bfloat16)``), and against the :data:`A8_ARMS` in the A8 regime
    (bf16 metadata, ``act_bits_map={2: 8}``).  Returns the perplexities
    (``ppl_<arm>``), the relative deltas (``rel_delta_<arm>``) and the
    final train loss."""
    from ..utils.convert import prepare_params_for_cuda
    from .llama import LlamaConfig
    from .llama_loader import quantize_llama_params

    dev = resolve_device(device)
    base = dict(vocab_size=256, hidden_size=hidden, intermediate_size=2 * hidden,
                num_layers=layers, num_heads=4, num_kv_heads=2, max_seq_len=seq_len,
                rope_theta=10000.0, dtype=torch.float32)
    model_fp, final_loss = train_byte_lm(LlamaConfig(quantized=False, **base), steps=steps,
                                         seq_len=seq_len, seed=seed, device=dev)
    held = byte_corpus("eval")
    tokens = torch.from_numpy(held[: (len(held) // seq_len) * seq_len].reshape(1, -1)).to(dev)

    out = {"train_loss": final_loss, "ppl_fp": perplexity(model_fp, tokens)}

    def arm(name, model):
        ppl = perplexity(model, tokens)
        out[f"ppl_{name}"] = ppl
        out[f"rel_delta_{name}"] = (ppl - out["ppl_fp"]) / out["ppl_fp"]

    cfgs = gate_configs(base)
    for name, cfg_q in cfgs.items():
        arm(name, quantize_llama_params(model_fp, cfg_q, dev))
    arm("w4g64_bf16meta", prepare_params_for_cuda(
        quantize_llama_params(model_fp, cfgs["w4g64"], dev), torch.bfloat16))
    for name in A8_ARMS:
        arm(f"{name}_a8", prepare_params_for_cuda(
            quantize_llama_params(model_fp, cfgs[name], dev), torch.bfloat16,
            act_bits_map={2: 8}))
    return out
