"""Parameter conversion and loading, checkpoints, metrics logging,
profiling and micro-benchmark timing."""

from .benchmark import time_fn_pytree, time_op  # noqa: F401

from .convert import (  # noqa: F401
    MPQ_STRATEGIES,
    count_quantized_bytes,
    get_mpq_config,
    prepare_for_inference,
    prepare_for_training,
    quantize_params,
)
from .metrics import (  # noqa: F401
    CSVLogger,
    JSONLLogger,
    MetricsLogger,
    StdoutLogger,
    WandbLogger,
)
