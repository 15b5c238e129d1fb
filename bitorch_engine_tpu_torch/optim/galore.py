"""GaLore low-rank gradient projector (the counterpart of ``optim/galore.py``).

An orthonormal factor from the SVD of the gradient (``torch.linalg.svd`` in
f32), refreshed every ``update_proj_gap`` steps and on first use;
gradients are projected to rank ``r`` for the optimizer's moments and
projected back before the weight update.  Orientation follows the JAX
package's (the reference's 'std') rule: a tall-or-square gradient
(``shape[0] >= shape[1]``) projects on the right (``g @ orthoᵀ``), a wide
one on the left.  Singular vectors may change sign between LAPACK builds;
the projected-then-restored gradient does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GaLoreConfig:
    rank: int = 128
    update_proj_gap: int = 200
    scale: float = 0.25


@dataclasses.dataclass
class GaLoreState:
    """``ortho``: ``(rank, n)`` (right) or ``(m, rank)`` (left), ``None``
    until the first projection computes it."""

    right: bool
    rank: int
    ortho: Optional[torch.Tensor] = None

    def projected_shape(self, shape: Tuple[int, int]) -> Tuple[int, int]:
        return (shape[0], self.rank) if self.right else (self.rank, shape[1])


def galore_init(grad_shape: Tuple[int, int], rank: int) -> GaLoreState:
    m, n = grad_shape
    right = m >= n
    return GaLoreState(right=right, rank=min(rank, n) if right else min(rank, m))


def galore_project(
    state: GaLoreState, grad: torch.Tensor, step: int, cfg: GaLoreConfig
) -> torch.Tensor:
    """The projected gradient; refreshes ``state.ortho`` on schedule (or
    while it is unset) in place."""
    g32 = grad.float()
    if state.ortho is None or step % cfg.update_proj_gap == 0:
        u, _, vh = torch.linalg.svd(g32, full_matrices=False)
        state.ortho = vh[: state.rank, :] if state.right else u[:, : state.rank]
    return g32 @ state.ortho.T if state.right else state.ortho.T @ g32


def galore_project_back(
    state: GaLoreState, low_rank_grad: torch.Tensor, cfg: GaLoreConfig
) -> torch.Tensor:
    full = low_rank_grad @ state.ortho if state.right else state.ortho @ low_rank_grad
    return full * cfg.scale
