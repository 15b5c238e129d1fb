"""DiodeMix and GaLore (the counterpart of ``bitorch_engine_tpu/optim``)."""

from .diode import DiodeHyperParams, DiodeMix
from .galore import GaLoreConfig, GaLoreState

__all__ = ["DiodeHyperParams", "DiodeMix", "GaLoreConfig", "GaLoreState"]
