"""Quantize an LLM checkpoint and generate text: the PyTorch twin of
``examples/llm/quantize_and_generate.py``.

1. load a safetensors checkpoint (HF Llama layout, or GPTQ via --gptq)
   through the port's own reader (no ``safetensors`` package needed);
2. quantize it at load into the kernel form (MPQ w4g128 by default,
   ``--strategy``), where the JAX script relayouts its params for the TPU;
3. run batched greedy generation with the KV-cache decode loop.

Runs on the card unless given ``--cpu``; ``--demo`` builds a tiny random
model on the CPU so the example is always runnable:

    python examples_torch/llm/quantize_and_generate.py --demo
    python examples_torch/llm/quantize_and_generate.py --checkpoint model.safetensors \
        --config llama3-8b --int8-kv --int8-embed --head-bits 4

``--prompt-ids`` takes comma-separated ids; rows separated by ``;`` make a
batch (rows of one length).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np

# --config name → the port's config factory (models/llama.py)
CONFIGS = {"tiny": "tiny_llama", "llama2-7b": "llama2_7b", "llama3-8b": "llama3_8b"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", help="safetensors file (HF Llama keys)")
    p.add_argument("--gptq", action="store_true", help="checkpoint is GPTQ-format")
    p.add_argument("--strategy", default="4-128-256")
    p.add_argument("--mbwq", help='mixed-bit JSON, e.g. \'{"bits":[4,2],"bits_prop":[0.75,0.25],"group_size":{"4":64,"2":64}}\'')
    p.add_argument("--prompt-ids", default="1,2,3,4",
                   help="comma-separated token ids; ';' separates the rows of a batch")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--demo", action="store_true", help="tiny random model demo (CPU)")
    p.add_argument("--cpu", action="store_true", help="run the plain path on the CPU")
    p.add_argument(
        "--config", default="tiny", choices=tuple(CONFIGS),
        help="model architecture the checkpoint matches",
    )
    p.add_argument("--head-bits", type=int, default=0,
                   help="untie lm_head at this bit width (0 = tied)")
    p.add_argument("--int8-embed", action="store_true",
                   help="int8 per-row embedding (+tied head)")
    p.add_argument("--int8-kv", action="store_true", help="int8 KV cache")
    return p.parse_args(argv)


def build(argv=None):
    """The model and the prompt ``main`` generates from: ``(model, prompt
    (b, plen) int64 on the model's device, args)``."""
    import torch

    from bitorch_engine_tpu_torch.device import resolve_device
    from bitorch_engine_tpu_torch.models import llama

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu or args.demo else None)
    rows = [[int(t) for t in row.split(",")] for row in args.prompt_ids.split(";")]
    prompt = torch.tensor(rows, dtype=torch.int64, device=dev)
    if args.demo:
        cfg = llama.tiny_llama(dtype=torch.float32)
        if args.mbwq:
            strat = json.loads(args.mbwq)
            cfg = llama.tiny_llama(
                dtype=torch.float32,
                mbwq_strategy=tuple(zip(strat["bits"], strat["bits_prop"])),
                group_size=min(int(v) for v in strat["group_size"].values()),
            )
        return llama.LlamaModel(cfg, device=dev, seed=0), prompt, args

    # real-checkpoint path: HF-layout safetensors → kernel-form model
    if not args.checkpoint:
        raise SystemExit("need --checkpoint FILE or --demo")
    from bitorch_engine_tpu_torch.models.llama_loader import load_llama_from_safetensors
    from bitorch_engine_tpu_torch.utils.convert import get_mpq_config

    mpq = get_mpq_config(args.strategy)
    cfg = getattr(llama, CONFIGS[args.config])(
        w_bit=mpq["w_bit"],
        group_size=mpq["group_size"],
        quantize_embed=args.int8_embed,
        head_w_bit=args.head_bits or None,
        kv_cache_dtype="int8" if args.int8_kv else "bf16",
        dtype=torch.float32 if args.cpu else torch.bfloat16,
    )
    model = load_llama_from_safetensors(args.checkpoint, cfg, cfg.dtype, device=dev)
    return model, prompt, args


def main(argv=None):
    """Build, generate greedily, print; returns the ids ``(b, plen +
    max_new_tokens)`` as a numpy array."""
    import torch

    from bitorch_engine_tpu_torch.models.generate import generate

    model, prompt, args = build(argv)
    with torch.no_grad():
        out = generate(model, prompt, max_new_tokens=args.max_new_tokens)
    ids = out.cpu().numpy()
    for row in ids:
        print("generated ids:", row.tolist())
    return ids


if __name__ == "__main__":
    main()
