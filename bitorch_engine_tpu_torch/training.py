"""Training-step helpers: one forward, backward and DiodeMix step.

The counterpart of ``bitorch_engine_tpu/training.py``.  PyTorch keeps the
parameters in the model, so the step is stateful: ``make_train_step(model,
loss_fn, hp)`` returns ``train_step(batch) -> {"loss", "aux"}``, whose
optimizer is ``train_step.optimizer`` (a :class:`DiodeMix`).  The quantized
layers' weight gradients ride in their grad shadows; call
``utils.convert.prepare_for_training(model)`` first.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from .optim import DiodeHyperParams, DiodeMix


def create_train_state(model: nn.Module, hp: Optional[DiodeHyperParams] = None,
                       seed: int = 0) -> DiodeMix:
    """The optimizer state of a training run: DiodeMix over ``model``
    (``seed``: the binary regimes' initial moments)."""
    return DiodeMix(model, hp, seed)


def make_train_step(
    model: nn.Module,
    loss_fn: Callable[[nn.Module, Any], Any],
    hp: Optional[DiodeHyperParams] = None,
    seed: int = 0,
) -> Callable[[Any], Dict[str, Any]]:
    """``train_step(batch) -> {"loss", "aux"}``: zero the gradients, run
    ``loss_fn(model, batch)`` (a scalar loss, or a ``(loss, aux)`` tuple
    whose ``aux`` is returned detached; otherwise ``aux`` is ``None``),
    backward, one DiodeMix step.  The gradients of the step stay in
    ``.grad`` until the next one."""
    optimizer = create_train_state(model, hp, seed)

    def train_step(batch) -> Dict[str, Any]:
        optimizer.zero_grad()
        out = loss_fn(model, batch)
        loss, aux = out if isinstance(out, tuple) else (out, None)
        loss.backward()
        optimizer.step()
        if isinstance(aux, torch.Tensor):
            aux = aux.detach()
        return {"loss": loss.detach(), "aux": aux}

    train_step.optimizer = optimizer
    return train_step


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy against integer labels, in f32."""
    return nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1).long()
    )


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).float().mean()
