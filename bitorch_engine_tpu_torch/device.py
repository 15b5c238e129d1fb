"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a ``device``
of ``None`` means ``cuda``, and without a usable GPU that raises rather than
quietly running on the CPU.  Pass ``device="cpu"`` to run the plain PyTorch
path (the CPU tests do).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def require_cuda() -> None:
    """Raise with the reason when no CUDA device can be used."""
    if not torch.cuda.is_available():
        reason = (
            "this PyTorch build has no CUDA support"
            if torch.version.cuda is None
            else "no CUDA device is visible"
        )
        raise RuntimeError(
            f"bitorch_engine_tpu_torch needs a CUDA GPU: {reason}. "
            "Pass device='cpu' to run the plain PyTorch path on the CPU."
        )


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (checked); anything else as given (a CUDA device
    is checked too)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    return dev
