"""Command-line tools: quantize / inspect safetensors checkpoints.

Usage:
    python -m bitorch_engine_tpu_torch.tools.cli quantize \
        --input model.safetensors --output q.safetensors \
        --strategy 4-128-256 [--asym] [--device cpu]
    python -m bitorch_engine_tpu_torch.tools.cli inspect --input q.safetensors

The counterpart of ``bitorch_engine_tpu/tools/cli.py``: the same rules and
output, read and written with the port's own safetensors reader and writer
(``utils/ingest.py``; no ``safetensors`` package needed).  ``quantize`` runs
on the card unless given ``--device cpu``; both give the same bits.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from ..ops.quant import quantize_mpq
from ..utils.convert import get_mpq_config
from ..utils.ingest import load_safetensors, save_safetensors


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``float32``, ``int32``, ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


def cmd_quantize(args) -> int:
    """RTN-quantize every 2-D tensor whose name ends in ``--weight-suffix``
    and whose rows are a multiple of the group size (rows are K): it is
    written as ``<base>.qweight`` (packed int32), ``<base>.scales`` and
    ``<base>.zeros`` (``<base>.qzeros``, packed, under ``--asym``); every
    other tensor is copied unchanged."""
    dev = resolve_device(args.device)
    cfg = get_mpq_config(args.strategy)
    tensors = load_safetensors(args.input)
    out = {}
    n_quant = 0
    for name, t in tensors.items():
        is_weight = (
            t.dim() == 2
            and name.endswith(args.weight_suffix)
            and t.shape[0] % cfg["group_size"] == 0
        )
        if not is_weight:
            out[name] = t
            continue
        qt = quantize_mpq(t.to(dev, torch.float32), w_bit=cfg["w_bit"],
                          group_size=cfg["group_size"], asym=args.asym)
        base = name[: -len(args.weight_suffix)] + "."
        out[base + "qweight"] = qt.packed.cpu()
        out[base + "scales"] = qt.scales.cpu()
        out[base + ("qzeros" if args.asym else "zeros")] = qt.zeros.cpu()
        n_quant += 1
    save_safetensors(args.output, out)
    print(f"quantized {n_quant} weights -> {args.output} ({args.strategy})")
    return 0


def cmd_inspect(args) -> int:
    tensors = load_safetensors(args.input)
    total = 0
    for name, t in sorted(tensors.items()):
        total += t.numel() * t.element_size()
        print(f"{name:60s} {_dtype_name(t.dtype):8s} {tuple(t.shape)}")
    print(f"total: {total/1e6:.1f} MB, {len(tensors)} tensors")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bitorch_engine_tpu_torch.tools.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("quantize", help="RTN-quantize fp weights in a safetensors file")
    q.add_argument("--input", required=True)
    q.add_argument("--output", required=True)
    q.add_argument("--strategy", default="4-128-256")
    q.add_argument("--asym", action="store_true")
    q.add_argument("--weight-suffix", default=".weight")
    q.add_argument("--device", default=None,
                   help="where to quantize (default cuda; cpu runs the plain path)")
    q.set_defaults(fn=cmd_quantize)

    i = sub.add_parser("inspect", help="list tensors in a safetensors file")
    i.add_argument("--input", required=True)
    i.set_defaults(fn=cmd_inspect)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
