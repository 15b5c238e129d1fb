"""End-to-end QAT training on the port, the counterpart of JAX
``tests/test_training_e2e.py``: the 1/4/8-bit ``QuantMLP`` learns a
synthetic task, and the 1-bit one passes the real-digits accuracy gate
(sklearn's bundled handwritten digits, > 90% held out)."""

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread a test process)

from bitorch_engine_tpu_torch.models.mlp import QuantMLP
from bitorch_engine_tpu_torch.optim import DiodeHyperParams
from bitorch_engine_tpu_torch.training import accuracy, cross_entropy_loss, make_train_step
from bitorch_engine_tpu_torch.utils import prepare_for_training


def _synthetic_task(n=512, d=64, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, d)).astype(np.float32) * 2.0
    labels = rng.integers(0, classes, size=n)
    x = centers[labels] + rng.standard_normal((n, d)).astype(np.float32) * 0.5
    return torch.from_numpy(x), torch.from_numpy(labels)


def _loss_fn(model, batch):
    logits = model(batch[0])
    return cross_entropy_loss(logits, batch[1]), accuracy(logits, batch[1])


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_quant_mlp_learns(bits):
    x, y = _synthetic_task()
    model = prepare_for_training(QuantMLP(in_features=64, hidden=128, bits=bits, device="cpu",
                                          sample=x[:8]))
    lr = 1e-3 if bits == 1 else 5e-3
    step = make_train_step(model, _loss_fn, DiodeHyperParams(lr=lr))
    accs = [float(step((x, y))["aux"]) for _ in range(30)]
    assert accs[-1] > 0.8, f"bits={bits}: acc trajectory {accs[-5:]}"


def test_quant_mlp_real_digits_accuracy_gate():
    """sklearn's bundled handwritten digits (1797 8x8 scans, UCI optdigits:
    real data, no network): a 1-bit-hidden QuantMLP trained with DiodeMix
    must exceed 90% held-out accuracy."""
    sklearn_datasets = pytest.importorskip("sklearn.datasets")
    d = sklearn_datasets.load_digits()
    x = d.data.astype(np.float32) / 16.0
    y = np.asarray(d.target, dtype=np.int64)
    perm = np.random.default_rng(0).permutation(len(x))
    x, y = torch.from_numpy(x[perm]), torch.from_numpy(y[perm])
    n_test = len(x) // 5
    xtr, ytr, xte, yte = x[n_test:], y[n_test:], x[:n_test], y[:n_test]

    model = prepare_for_training(QuantMLP(in_features=64, hidden=512, bits=1, device="cpu",
                                          sample=xtr[:8]))
    step = make_train_step(model, _loss_fn, DiodeHyperParams(lr=1e-3))
    bs = 128
    for epoch in range(8):
        order = torch.from_numpy(np.random.default_rng(epoch).permutation(len(xtr)))
        for i in range(len(xtr) // bs):
            idx = order[i * bs : (i + 1) * bs]
            step((xtr[idx], ytr[idx]))
    with torch.no_grad():
        test_acc = float(accuracy(model(xte), yte))
    assert test_acc > 0.90, f"real-digits 1-bit accuracy gate: {test_acc:.4f}"
