"""Parameter conversion and loading, checkpoints, metrics logging,
profiling and micro-benchmark timing.

The names below are loaded on first use (PEP 562), so that the model and
op modules can import ``utils.profiling`` for their spans without pulling
in ``utils.convert``, which imports them."""

import importlib

# exported name -> the submodule that defines it
_EXPORTS = {
    "time_fn_pytree": "benchmark",
    "time_op": "benchmark",
    "MPQ_STRATEGIES": "convert",
    "count_quantized_bytes": "convert",
    "get_mpq_config": "convert",
    "prepare_for_inference": "convert",
    "prepare_for_training": "convert",
    "quantize_params": "convert",
    "CSVLogger": "metrics",
    "JSONLLogger": "metrics",
    "MetricsLogger": "metrics",
    "StdoutLogger": "metrics",
    "WandbLogger": "metrics",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
