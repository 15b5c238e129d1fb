"""Training-step helpers: one forward, backward and DiodeMix step.

The counterpart of ``bitorch_engine_tpu/training.py``.  PyTorch keeps the
parameters in the model, so the step is stateful: ``make_train_step(model,
loss_fn, hp)`` returns ``train_step(batch) -> {"loss", "aux"}``, whose
optimizer is ``train_step.optimizer`` (a :class:`DiodeMix`).  The quantized
layers' weight gradients ride in their grad shadows; call
``utils.convert.prepare_for_training(model)`` first.

With a ``mesh`` (``parallel.mesh``) the step is one rank's part of a data-
and sequence-parallel step, every rank holding the whole weights:

* ``train_step(batch)`` takes the global batch and keeps this rank's part
  (:func:`shard_batch`: rows over ``dp``, positions over ``sp``; ``fsdp``
  ranks share their rows);
* ``loss_fn`` returns this rank's *share* of the global loss, its tokens'
  sum over the global token count (:func:`cross_entropy_loss` with the
  mesh), so that the shares sum to the global mean;
* after the backward the gradients (grad shadows and fp parameters) are
  summed in f32 over ``dp`` and ``sp`` (:func:`sum_gradients`): the
  all-reduce GSPMD inserts in the JAX package.  Under sequence parallelism
  a rank's backward already holds the other ranks' queries' share of its
  K/V (the ring's or the all-to-all's backward carried it); the sum adds
  the weights' shares;
* DiodeMix runs on the summed gradients (``DiodeMix(mesh=)``: each
  ``fsdp`` rank updates its share and gathers the rest); the returned loss
  is the global one.

A tp-sharded model (``models.llama_sharding.shard_llama_params`` on the
same ``(dp, fsdp, tp)`` mesh, before or after ``prepare_for_training``)
trains through the same step, as the JAX package's one GSPMD program over
that mesh: every tp rank takes the same batch (``shard_batch`` splits over
dp and sp only) and computes the whole loss (the model's collectives give
every rank the whole logits); its grad shadows are its shards' and hold
its shards' gradients, its replicated parameters' gradients are whole and
equal on every tp rank (the model's backward sums the column-parallel
inputs' cotangents over tp), so nothing is summed over tp here; DiodeMix
keeps each shard's moments on its rank.

Each step is a coarse span ``bie.train.step`` (``utils/profiling``);
while a profiler records, fine spans ``bie.train.forward`` (``loss_fn``),
``bie.train.backward`` (the backward and the sums over dp and sp) and
``bie.train.optimizer`` (the DiodeMix step, with its own
``bie.diode.*`` spans) nest under it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .optim import DiodeHyperParams, DiodeMix
from .parallel.comm import all_reduce
from .utils.profiling import annotate

# the mesh axes a training batch is split over: rows over dp, positions over sp
DATA_AXES = ("dp", "sp")


def create_train_state(model: nn.Module, hp: Optional[DiodeHyperParams] = None,
                       seed: int = 0, mesh=None) -> DiodeMix:
    """The optimizer state of a training run: DiodeMix over ``model``
    (``seed``: the binary regimes' initial moments; ``mesh``: see
    ``DiodeMix``)."""
    return DiodeMix(model, hp, seed, mesh=mesh)


def shard_batch(batch, mesh):
    """This rank's part of a global batch: every tensor's rows (dim 0)
    split over ``dp`` and, for tensors of two or more dimensions, its
    positions (dim 1) over ``sp``.  Tuples, lists and dicts are walked."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    for dim, axis in enumerate(DATA_AXES):
        n = mesh.size(axis) if axis in mesh.shape else 1
        if n == 1 or batch.dim() <= dim:
            continue
        if batch.shape[dim] % n:
            raise ValueError(f"batch dimension {dim} ({batch.shape[dim]}) does not split over "
                             f"{axis}={n}")
        size = batch.shape[dim] // n
        batch = batch.narrow(dim, mesh.coord(axis) * size, size)
    return batch


def _data_axes(mesh) -> Tuple[str, ...]:
    """The axes of :data:`DATA_AXES` that ``mesh`` names (a mesh may lay
    out dp, sp, both or neither)."""
    return tuple(a for a in DATA_AXES if a in mesh.shape)


def _sum_over_data_axes(mesh, t: torch.Tensor) -> torch.Tensor:
    for axis in _data_axes(mesh):
        all_reduce(mesh, t, axis)
    return t


def sum_gradients(optimizer: DiodeMix, mesh) -> None:
    """Sum every gradient DiodeMix reads (grad shadows, fp parameters) over
    ``dp`` and ``sp``, in f32: one flat buffer, one all-reduce an axis.  A
    bf16 parameter's sum is cast back to its gradient's dtype."""
    if all(mesh.size(a) == 1 for a in _data_axes(mesh)):
        return
    params = optimizer.trainable()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    _sum_over_data_axes(mesh, flat)
    off = 0
    for p, g in zip(params, grads):
        p.grad = g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()


def make_train_step(
    model: nn.Module,
    loss_fn: Callable[[nn.Module, Any], Any],
    hp: Optional[DiodeHyperParams] = None,
    seed: int = 0,
    mesh=None,
) -> Callable[[Any], Dict[str, Any]]:
    """``train_step(batch) -> {"loss", "aux"}``: zero the gradients, run
    ``loss_fn(model, batch)`` (a scalar loss, or a ``(loss, aux)`` tuple
    whose ``aux`` is returned detached; otherwise ``aux`` is ``None``),
    backward, one DiodeMix step.  The gradients of the step stay in
    ``.grad`` until the next one.  With a ``mesh``: this rank's part of the
    batch, its loss share, the gradients summed over dp and sp (see the
    module's notes); a tp-sharded model trains on the same mesh."""
    optimizer = create_train_state(model, hp, seed, mesh)

    def train_step(batch) -> Dict[str, Any]:
        with annotate("bie.train.step"):
            optimizer.zero_grad()
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            with annotate("bie.train.forward", fine=True):
                out = loss_fn(model, batch)
            loss, aux = out if isinstance(out, tuple) else (out, None)
            with annotate("bie.train.backward", fine=True):
                loss.backward()
                if mesh is not None:
                    sum_gradients(optimizer, mesh)
                    loss = _sum_over_data_axes(mesh, loss.detach().float().clone())
            with annotate("bie.train.optimizer", fine=True):
                optimizer.step()
        if isinstance(aux, torch.Tensor):
            aux = aux.detach()
        return {"loss": loss.detach(), "aux": aux}

    train_step.optimizer = optimizer
    return train_step


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean softmax cross entropy against integer labels, in f32; labels of
    -100 count for nothing.

    With a ``mesh``: this rank's share of the mean over the *global* batch,
    the sum over its labels divided by the count of labels over ``dp`` and
    ``sp``.  A sequence-parallel step shards the labels with the tokens
    (the labels made from the global sequence: a shard's last label is the
    next shard's first token)."""
    logits2, labels2 = logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1).long()
    if mesh is None:
        return nn.functional.cross_entropy(logits2, labels2)
    # the count stays on the logits' device (no host sync; NCCL takes it), in
    # f32: exact up to 2**24 labels
    count = (labels2 != -100).sum().float().reshape(1)
    total = nn.functional.cross_entropy(logits2, labels2, reduction="sum")
    return total / _sum_over_data_axes(mesh, count)[0]


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).float().mean()
