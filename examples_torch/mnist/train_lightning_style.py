"""Trainer-integration example, the "bring your own trainer" story: the
PyTorch twin of ``examples/mnist/train_lightning_style.py``.

1. define a plain ``nn.Module`` MLP (no engine layers anywhere in the model
   code);
2. quantize it in place with ``utils.convert.quantize_params`` (the hidden
   ``fc2`` linear becomes an ``MPQLinear``; ``fc1``'s 784 inputs are not
   group-aligned and the head stays fp);
3. train with the generic ``training.make_train_step`` + DiodeMix;
4. fan metrics out to CSV + JSONL + stdout backends
   (``utils.metrics.MetricsLogger``; add ``WandbLogger`` where wandb
   exists);
5. checkpoint mid-run (``utils.checkpoint``), reload the checkpoint into a
   freshly built model (every tensor equal), then resume training from it.

Usage:
    python examples_torch/mnist/train_lightning_style.py --epochs 2 [--cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np


def plain_mlp(device):
    """A plain torch MLP (784 → 512 → 512 → 10, hardtanh), its weights from
    torch's default init under seed 0."""
    import torch
    from torch import nn

    class PlainMLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(784, 512)
            self.fc2 = nn.Linear(512, 512)
            self.head = nn.Linear(512, 10)

        def forward(self, x):
            x = x.reshape(x.shape[0], -1)
            x = nn.functional.hardtanh(self.fc1(x))
            x = nn.functional.hardtanh(self.fc2(x))
            return self.head(x)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return PlainMLP().to(device)


def main(argv=None):
    """Train, checkpoint, reload and resume; returns ``{"test_acc",
    "resumed_acc", "reload_tensors", "reload_max_abs_diff"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--strategy", default="4-128-256",
                    help="MPQ strategy string for the hidden layers")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--out", default=None, help="run dir (logs + checkpoint)")
    args = ap.parse_args(argv)

    import torch

    from bitorch_engine_tpu_torch.device import resolve_device
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import accuracy, cross_entropy_loss, make_train_step
    from bitorch_engine_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from bitorch_engine_tpu_torch.utils.convert import (
        load_jax_params,
        prepare_for_training,
        quantize_params,
    )
    from bitorch_engine_tpu_torch.utils.metrics import (
        CSVLogger,
        JSONLLogger,
        MetricsLogger,
        StdoutLogger,
    )
    from examples_torch.mnist.train_mnist import load_mnist, load_sklearn_digits, synthetic_digits

    dev = resolve_device("cpu" if args.cpu else None)

    # --- data (same loaders as the sibling example) ------------------------
    data = load_mnist(args.data_dir) or load_sklearn_digits() or synthetic_digits()
    (xtr, ytr), (xte, yte) = data
    xtr = torch.from_numpy(xtr.reshape(len(xtr), -1).astype(np.float32)).to(dev) / 255.0
    xte = torch.from_numpy(xte.reshape(len(xte), -1).astype(np.float32)).to(dev) / 255.0
    ytr = torch.from_numpy(np.asarray(ytr, np.int64)).to(dev)
    yte = torch.from_numpy(np.asarray(yte, np.int64)).to(dev)

    # --- 1+2. a PLAIN model, quantized IN PLACE: fc2 -> MPQLinear ----------
    def build():
        return prepare_for_training(
            quantize_params(plain_mlp(dev), path_pattern=r"fc2/weight$", strategy=args.strategy))

    model = build()

    def loss_fn(m, batch):
        logits = m(batch[0])
        return cross_entropy_loss(logits, batch[1]), accuracy(logits, batch[1])

    def test_accuracy(m):
        with torch.no_grad():
            return float(accuracy(m(xte), yte))

    hp = DiodeHyperParams(lr=args.lr)
    step = make_train_step(model, loss_fn, hp)

    run_dir = args.out or tempfile.mkdtemp(prefix="bitorch_run_")
    os.makedirs(run_dir, exist_ok=True)
    ckpt_path = os.path.join(run_dir, "ckpt")

    n = len(xtr)
    bs = args.batch_size
    rng = np.random.default_rng(0)
    gstep = 0

    # --- 3+4. generic trainer loop with fanned-out loggers -----------------
    with MetricsLogger(
        [
            CSVLogger(os.path.join(run_dir, "metrics.csv")),
            JSONLLogger(os.path.join(run_dir, "metrics.jsonl")),
            StdoutLogger(every=50),
        ]
    ) as logger:
        for epoch in range(args.epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(dev)
            for i in range(0, n - bs + 1, bs):
                idx = perm[i : i + bs]
                metrics = step((xtr[idx], ytr[idx]))
                gstep += 1
                logger.log({"loss": metrics["loss"], "acc": metrics["aux"]}, gstep)
            test_acc = test_accuracy(model)
            logger.log({"test_acc": test_acc}, gstep)
            print(f"epoch {epoch}: test acc {test_acc:.4f}")

        # --- 5. checkpoint mid-run, reload into a fresh model, resume ------
        save_checkpoint(ckpt_path, model, pack=False)
        resumed = load_jax_params(build(), load_checkpoint(ckpt_path))
        saved = dict(list(model.named_parameters()) + list(model.named_buffers()))
        loaded = dict(list(resumed.named_parameters()) + list(resumed.named_buffers()))
        if set(saved) != set(loaded):
            raise RuntimeError(f"reloaded tensors {sorted(loaded)} != saved {sorted(saved)}")
        diff = max(float((saved[k].detach().double() - loaded[k].detach().double()).abs().max())
                   if saved[k].numel() else 0.0 for k in saved)
        print(f"checkpoint reloaded: {len(saved)} tensors, max |d| {diff:g}")
        step = make_train_step(resumed, loss_fn, hp)
        for i in range(0, min(n - bs + 1, 5 * bs), bs):
            metrics = step((xtr[i : i + bs], ytr[i : i + bs]))
            gstep += 1
            logger.log({"loss": metrics["loss"], "resumed": 1.0}, gstep)
        resumed_acc = test_accuracy(resumed)
        logger.log({"test_acc_resumed": resumed_acc}, gstep)

    print(f"final (resumed) test acc {resumed_acc:.4f}; run dir: {run_dir}")
    assert os.path.exists(os.path.join(run_dir, "metrics.csv"))
    return {"test_acc": test_acc, "resumed_acc": resumed_acc, "reload_tensors": len(saved),
            "reload_max_abs_diff": diff}


if __name__ == "__main__":
    main()
