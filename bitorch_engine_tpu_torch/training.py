"""Training-step helpers: one forward, backward and DiodeMix step.

The counterpart of ``bitorch_engine_tpu/training.py``.  PyTorch keeps the
parameters in the model, so the step is stateful: ``make_train_step(model,
loss_fn, hp)`` returns ``train_step(batch) -> metrics``, whose optimizer is
``train_step.optimizer`` (a :class:`DiodeMix`).  The quantized layers'
weight gradients ride in their grad shadows; call
``utils.convert.prepare_for_training(model)`` first.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from .optim import DiodeHyperParams, DiodeMix


def create_train_state(model: nn.Module, hp: Optional[DiodeHyperParams] = None) -> DiodeMix:
    """The optimizer state of a training run: DiodeMix over ``model``."""
    return DiodeMix(model, hp)


def make_train_step(
    model: nn.Module,
    loss_fn: Callable[[nn.Module, Any], torch.Tensor],
    hp: Optional[DiodeHyperParams] = None,
) -> Callable[[Any], Dict[str, torch.Tensor]]:
    """``train_step(batch) -> {"loss"}``: zero the gradients, run
    ``loss_fn(model, batch)`` (a scalar loss), backward, one DiodeMix step.
    The gradients of the step stay in ``.grad`` until the next one."""
    optimizer = create_train_state(model, hp)

    def train_step(batch) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    train_step.optimizer = optimizer
    return train_step


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy against integer labels, in f32."""
    return nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1).long()
    )


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).float().mean()
