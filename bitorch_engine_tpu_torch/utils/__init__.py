"""Parameter conversion and loading, checkpoints, metrics logging and
profiling."""

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
