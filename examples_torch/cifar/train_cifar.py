"""Train a binary/4-bit conv net on CIFAR-10 with DiodeMix: the PyTorch
twin of ``examples/cifar/train_cifar.py``.

Loads CIFAR-10 from the python-pickle batches if present (``--data-dir``;
nothing is downloaded).  Otherwise it builds the JAX script's real-image
stand-in from the two natural RGB photos bundled inside scikit-learn
(``load_sample_images``): 32x32x3 patches labeled by (photo, top/bottom
region) = 4 classes, with spatially disjoint train/test crop columns.
Without scikit-learn it uses a synthetic 4-class task of the same shape.
Runs on the card unless given ``--cpu``.

Usage:
    python examples_torch/cifar/train_cifar.py --bits 1 --epochs 2 [--cpu]
"""

import argparse
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np


def load_cifar10(data_dir):
    batches = []
    for i in range(1, 6):
        path = os.path.join(data_dir, f"data_batch_{i}")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            batches.append(pickle.load(f, encoding="bytes"))
    xs = np.concatenate([b[b"data"] for b in batches]).reshape(-1, 3, 32, 32)
    ys = np.concatenate([np.asarray(b[b"labels"]) for b in batches])
    with open(os.path.join(data_dir, "test_batch"), "rb") as f:
        tb = pickle.load(f, encoding="bytes")
    xt = np.asarray(tb[b"data"]).reshape(-1, 3, 32, 32)
    yt = np.asarray(tb[b"labels"])
    to_nhwc = lambda x: (x.transpose(0, 2, 3, 1).astype(np.float32) / 255.0 - 0.5) * 2
    return (to_nhwc(xs), ys), (to_nhwc(xt), yt)


def natural_patches(n_train=4096, n_test=1024, seed=0):
    """Real-image fallback task: 32x32 RGB crops of the two natural photos
    that ship inside scikit-learn (no network needed), labeled by
    (photo, top/bottom half) -> 4 classes.  Train crops come from the left
    75% of columns, test crops from the right 25% (disjoint pixels).
    Returns None if sklearn is unavailable."""
    try:
        from sklearn.datasets import load_sample_images
    except ImportError:
        return None

    images = load_sample_images().images  # two (427, 640, 3) uint8 photos
    rng = np.random.default_rng(seed)

    def make(n, col_lo, col_hi):
        xs = np.empty((n, 32, 32, 3), np.float32)
        ys = np.empty((n,), np.int64)
        for i in range(n):
            img_i = int(rng.integers(0, len(images)))
            img = images[img_i]
            h, w, _ = img.shape
            half = int(rng.integers(0, 2))  # 0 = top, 1 = bottom
            r0 = int(rng.integers(0, h // 2 - 32)) + (h // 2) * half
            c0 = int(rng.integers(col_lo, col_hi - 32))
            patch = img[r0 : r0 + 32, c0 : c0 + 32].astype(np.float32)
            xs[i] = (patch / 255.0 - 0.5) * 2
            ys[i] = img_i * 2 + half
        return xs, ys

    w = images[0].shape[1]
    split = int(w * 0.75)
    return make(n_train, 0, split), make(n_test, split, w)


def synthetic_patches(n_train=4096, n_test=1024, n_classes=4, seed=0):
    """Synthetic 32x32x3 task (class prototypes + noise), the last-resort
    fallback where scikit-learn is missing."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((n_classes, 32, 32, 3)).astype(np.float32) * 0.5

    def make(n):
        y = rng.integers(0, n_classes, n)
        x = protos[y] + rng.standard_normal((n, 32, 32, 3)).astype(np.float32) * 0.5
        return np.clip(x, -1.0, 1.0), y

    return make(n_train), make(n_test)


def main(argv=None):
    """Train and evaluate; returns ``{"test_acc", "loss", "train_acc"}`` of
    the last epoch."""
    p = argparse.ArgumentParser()
    p.add_argument("--bits", type=int, default=1, choices=[1, 4])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--data-dir", default=os.environ.get("CIFAR_DIR", "data/cifar-10-batches-py"))
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import torch

    from bitorch_engine_tpu_torch.device import resolve_device
    from bitorch_engine_tpu_torch.models.cnn import QuantConvNet
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import accuracy, cross_entropy_loss, make_train_step
    from bitorch_engine_tpu_torch.utils import prepare_for_training

    dev = resolve_device("cpu" if args.cpu else None)
    data = load_cifar10(args.data_dir)
    if data is None:
        data = natural_patches()
        if data is not None:
            print("# CIFAR batches not found; using the real-image fallback "
                  "(sklearn sample-photo patches, 4 classes)")
    if data is None:
        print("# no real dataset available; using the synthetic fallback task (4 classes)")
        data = synthetic_patches()
    (xtr, ytr), (xte, yte) = data
    xtr, xte = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in (xtr, xte))
    ytr, yte = (torch.from_numpy(np.asarray(a, np.int64)).to(dev) for a in (ytr, yte))

    n_classes = int(ytr.max()) + 1
    model = QuantConvNet(n_classes=n_classes, bits=args.bits, widths=(32, 64, 64, 128),
                         device=dev, seed=0, sample=xtr[:8])
    prepare_for_training(model)
    # binary sign-descent needs faster EMAs than the LLM-tuned defaults: with
    # beta2=0.9999 a sign flip takes ~1/(lr*(1-beta2)) steps
    betas = (0.9, 0.99) if args.bits == 1 else (0.99, 0.9999)
    hp = DiodeHyperParams(lr=args.lr, beta1=betas[0], beta2=betas[1])

    def loss_fn(model, batch):
        logits = model(batch[0])
        return cross_entropy_loss(logits, batch[1]), accuracy(logits, batch[1])

    step = make_train_step(model, loss_fn, hp)
    n = len(xtr)
    rng = np.random.default_rng(1)
    for epoch in range(args.epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        t0 = time.time()
        for i in range(n // args.batch_size):
            idx = perm[i * args.batch_size : (i + 1) * args.batch_size]
            m = step((xtr[idx], ytr[idx]))
        with torch.no_grad():
            acc = float(accuracy(model(xte[:1024]), yte[:1024]))
        print(
            f"epoch {epoch}: loss {float(m['loss']):.4f} "
            f"train_acc {float(m['aux']):.3f} test_acc {acc:.3f} ({time.time()-t0:.1f}s)"
        )
    print(f"final test accuracy ({args.bits}-bit convs): {acc:.3f}")
    return {"test_acc": acc, "loss": float(m["loss"]), "train_acc": float(m["aux"])}


if __name__ == "__main__":
    main()
