"""Full-parameter fine-tuning of a quantized Llama with DiodeMix: the
PyTorch twin of ``examples/llm/finetune.py``.

1. build a Llama whose projections are packed MPQ tensors;
2. attach grad shadows (``prepare_for_training``);
3. DiodeMix updates the *quantized* weights in place: unpack, AdamW step,
   zeros refresh every 5 steps, repack;
4. optionally shard the whole step over a (dp, tp) mesh of processes
   (``--mesh``: ``shard_llama_params`` and ``make_train_step(mesh=)`` on
   every rank of a gloo world; on the card the ranks share it).

A tiny model on synthetic next-token data, f32 on the CPU (``--cpu``) and
bf16 on the card:

    python examples_torch/llm/finetune.py --steps 30 [--cpu]
    python examples_torch/llm/finetune.py --steps 10 --mesh 1,2   # tp=2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--w-bit", type=int, default=4)
    p.add_argument("--mesh", help="dp,tp (e.g. 1,2): shards the step over dp*tp processes")
    p.add_argument(
        "--remat",
        action="store_true",
        help="rematerialize decoder blocks on backward (long-seq memory)",
    )
    p.add_argument("--cpu", action="store_true", help="run the plain path on the CPU")
    return p.parse_args(argv)


def train(argv=None, mesh=None):
    """Build, train ``--steps`` DiodeMix steps; returns the losses."""
    import torch

    from bitorch_engine_tpu_torch.device import resolve_device
    from bitorch_engine_tpu_torch.models.llama import LlamaModel, tiny_llama
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import cross_entropy_loss, make_train_step
    from bitorch_engine_tpu_torch.utils import prepare_for_training

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    cfg = tiny_llama(dtype=torch.float32 if args.cpu else torch.bfloat16, w_bit=args.w_bit,
                     remat=args.remat)
    model = prepare_for_training(LlamaModel(cfg, device=dev, seed=0))
    if mesh is not None:
        from bitorch_engine_tpu_torch.models.llama_sharding import shard_llama_params

        shard_llama_params(model, mesh)

    def loss_fn(model, batch):
        logits, _ = model(batch["tokens"])
        return cross_entropy_loss(logits, batch["labels"], mesh)

    step = make_train_step(model, loss_fn, DiodeHyperParams(lr=args.lr), mesh=mesh)

    # synthetic copy-task data: predict the next token of a fixed pattern
    gen = torch.Generator().manual_seed(1)
    seq = torch.randint(0, cfg.vocab_size, (1, args.seq + 1), generator=gen)
    seq = seq.repeat(args.batch, 1).to(dev)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    losses = []
    for i in range(args.steps):
        losses.append(float(step(batch)["loss"]))
        if mesh is None and (i % 5 == 0 or i == args.steps - 1):
            print(f"step {i:4d}  loss {losses[-1]:.4f}")
    return np.asarray(losses)


def train_rank(argv):
    """One rank of a ``--mesh`` world: its losses (every rank's are the
    global ones)."""
    from bitorch_engine_tpu_torch.parallel import make_mesh

    dp, tp = (int(v) for v in parse_args(argv).mesh.split(","))
    return {"losses": train(argv, make_mesh(dp=dp, tp=tp))}


def main(argv=None):
    """Train and print; returns the losses of every step."""
    args = parse_args(argv)
    if args.mesh:
        from bitorch_engine_tpu_torch.parallel.multiprocess import launch_world

        dp, tp = (int(v) for v in args.mesh.split(","))
        argv = list(sys.argv[1:] if argv is None else argv)
        losses = launch_world("examples_torch.llm.finetune:train_rank", dp * tp,
                              {"argv": argv}, timeout=1800.0)[0]["losses"]
        for i in sorted({*range(0, args.steps, 5), args.steps - 1}):
            print(f"step {i:4d}  loss {losses[i]:.4f}")
    else:
        losses = train(argv)
    first, last = float(losses[0]), float(losses[-1])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return losses


if __name__ == "__main__":
    main()
