"""Train a low-bit MLP on MNIST with DiodeMix: the PyTorch twin of
``examples/mnist/train_mnist.py``.

A 2-layer MLP whose hidden layer is a 1/4/8-bit quantized linear
(``QuantMLP``), trained end to end with gradients flowing to the quantized
weights and DiodeMix updating them directly, on the card unless given
``--cpu``.

Dataset: MNIST from an IDX/npz file if present (``--data-dir``; nothing is
downloaded); otherwise the real handwritten digits bundled with
scikit-learn (1797 8x8 scans, UCI optdigits), upsampled to 28x28 so the
model shapes match MNIST; without scikit-learn a synthetic task.

Usage:
    python examples_torch/mnist/train_mnist.py --bits 1 --epochs 3 [--cpu]
"""

import argparse
import gzip
import os
import struct
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np


def load_mnist(data_dir):
    """Load MNIST from idx-gz or npz files if available, else None."""
    npz = os.path.join(data_dir, "mnist.npz")
    if os.path.exists(npz):
        d = np.load(npz)
        return (d["x_train"], d["y_train"]), (d["x_test"], d["y_test"])

    def read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, = struct.unpack(">I", f.read(4))
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)

    for suffix in ("", ".gz"):
        try:
            xtr = read_idx(os.path.join(data_dir, f"train-images-idx3-ubyte{suffix}"))
            ytr = read_idx(os.path.join(data_dir, f"train-labels-idx1-ubyte{suffix}"))
            xte = read_idx(os.path.join(data_dir, f"t10k-images-idx3-ubyte{suffix}"))
            yte = read_idx(os.path.join(data_dir, f"t10k-labels-idx1-ubyte{suffix}"))
            return (xtr, ytr), (xte, yte)
        except FileNotFoundError:
            continue
    return None


def load_sklearn_digits(seed=0):
    """Real handwritten digits shipped inside scikit-learn (no network).

    1797 8x8 grayscale scans of hand-written digits (UCI optdigits test set).
    Upsampled 8x8 -> 28x28 by pixel repetition + crop so the example keeps
    MNIST-shaped inputs. Returns None if sklearn is unavailable.
    """
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        return None
    d = load_digits()
    x = d.data.reshape(-1, 8, 8).astype(np.float32) / 16.0
    # 8x8 -> 32x32 by 4x pixel repetition, center-crop to 28x28
    x = np.repeat(np.repeat(x, 4, axis=1), 4, axis=2)[:, 2:30, 2:30]
    y = d.target.astype(np.int32)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_test = len(x) // 5
    return (x[n_test:] * 255.0, y[n_test:]), (x[:n_test] * 255.0, y[:n_test])


def synthetic_digits(n_train=8000, n_test=2000, seed=0):
    """Synthetic 10-class 28x28 task (prototype digits + noise + shifts)."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((10, 28 * 28)).astype(np.float32)

    def make(n):
        y = rng.integers(0, 10, n)
        x = protos[y] + rng.standard_normal((n, 28 * 28)).astype(np.float32) * 0.8
        return x.reshape(n, 28, 28), y

    return make(n_train), make(n_test)


def main(argv=None):
    """Train and evaluate; returns ``{"test_acc", "loss", "train_acc"}`` of
    the last epoch."""
    p = argparse.ArgumentParser()
    p.add_argument("--bits", type=int, default=1, choices=[1, 4, 8])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--data-dir", default=os.environ.get("MNIST_DIR", "data/mnist"))
    p.add_argument("--cpu", action="store_true", help="run the plain path on the CPU")
    p.add_argument(
        "--log-dir",
        default=None,
        help="multi-logger output dir (CSV + JSONL + stdout; +wandb if "
        "WANDB_PROJECT is set)",
    )
    args = p.parse_args(argv)

    import torch

    from bitorch_engine_tpu_torch.device import resolve_device
    from bitorch_engine_tpu_torch.models.mlp import QuantMLP
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import accuracy, cross_entropy_loss, make_train_step
    from bitorch_engine_tpu_torch.utils import prepare_for_training

    dev = resolve_device("cpu" if args.cpu else None)
    data = load_mnist(args.data_dir)
    if data is None:
        data = load_sklearn_digits()
        if data is not None:
            print("# MNIST files not found; using real sklearn digits (8x8 scans -> 28x28)")
    if data is None:
        print("# no real dataset available; using the synthetic fallback task")
        (xtr, ytr), (xte, yte) = synthetic_digits()
    else:
        (xtr, ytr), (xte, yte) = data
    xtr = (xtr.reshape(len(xtr), -1).astype(np.float32) / 255.0 - 0.1307) / 0.3081 \
        if data is not None else xtr.reshape(len(xtr), -1)
    xte = (xte.reshape(len(xte), -1).astype(np.float32) / 255.0 - 0.1307) / 0.3081 \
        if data is not None else xte.reshape(len(xte), -1)
    xtr, xte = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in (xtr, xte))
    ytr, yte = (torch.from_numpy(np.asarray(a, np.int64)).to(dev) for a in (ytr, yte))

    model = QuantMLP(hidden=args.hidden, bits=args.bits, device=dev, seed=0,
                     sample=xtr[: args.batch_size])
    prepare_for_training(model)
    hp = DiodeHyperParams(lr=args.lr)

    def loss_fn(model, batch):
        logits = model(batch[0])
        return cross_entropy_loss(logits, batch[1]), accuracy(logits, batch[1])

    step = make_train_step(model, loss_fn, hp)

    logger = None
    if args.log_dir:
        from bitorch_engine_tpu_torch.utils.metrics import (
            CSVLogger,
            JSONLLogger,
            MetricsLogger,
            StdoutLogger,
        )

        backends = [
            CSVLogger(args.log_dir),
            JSONLLogger(args.log_dir),
            StdoutLogger(every=50),
        ]
        if os.environ.get("WANDB_PROJECT"):
            try:
                from bitorch_engine_tpu_torch.utils.metrics import WandbLogger

                backends.append(WandbLogger(os.environ["WANDB_PROJECT"]))
            except ImportError:
                print("# wandb not installed; skipping WandbLogger")
        logger = MetricsLogger(backends)

    n = len(xtr)
    steps_per_epoch = n // args.batch_size
    rng = np.random.default_rng(1)
    for epoch in range(args.epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        t0 = time.time()
        for i in range(steps_per_epoch):
            idx = perm[i * args.batch_size : (i + 1) * args.batch_size]
            metrics = step((xtr[idx], ytr[idx]))
            if logger is not None:
                logger.log(
                    {"loss": metrics["loss"], "train_acc": metrics["aux"]},
                    step=epoch * steps_per_epoch + i,
                )
        # eval
        with torch.no_grad():
            test_acc = float(accuracy(model(xte), yte))
        print(
            f"epoch {epoch}: loss {float(metrics['loss']):.4f} "
            f"train_acc {float(metrics['aux']):.4f} test_acc {test_acc:.4f} "
            f"({time.time() - t0:.1f}s)"
        )

    if logger is not None:
        logger.log({"test_acc": test_acc}, step=args.epochs * steps_per_epoch)
        logger.finalize()
    print(f"final test accuracy ({args.bits}-bit hidden layer): {test_acc:.4f}")
    return {"test_acc": test_acc, "loss": float(metrics["loss"]),
            "train_acc": float(metrics["aux"])}


if __name__ == "__main__":
    main()
