"""Published peaks of the card, and the least time work can take on it.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit; a card set lower runs slower under load, so every run
prints its ``power.limit`` beside its numbers.  ``least_seconds`` is the
roofline: the larger of operations over the peak rate and bytes over the
memory bandwidth (the bound arithmetic of ``chip_smoke.bound``).
"""

from __future__ import annotations

PEAKS = {
    "H100": {
        "bf16_flops": 989e12,
        "fp8_flops": 1979e12,
        "int8_ops": 1979e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "hbm_bytes": 80e9,
    },
}


def card_peaks(kind: str) -> dict:
    """The peak table of a card by its ``torch.cuda.get_device_name``."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    raise KeyError(f"no published peaks for {kind!r}")


def least_seconds(ops: float, nbytes: float, peaks: dict, rate: str = "bf16_flops") -> float:
    return max(ops / peaks[rate], nbytes / peaks["hbm_bytes_per_s"])
