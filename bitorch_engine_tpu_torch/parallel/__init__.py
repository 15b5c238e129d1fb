"""Parallel layouts over ``torch.distributed``: the counterpart of
``bitorch_engine_tpu/parallel`` for serving (the process mesh, the sharding
rules, the collectives, the ring-overlapped row-parallel MPQ product and the
process-world launcher).  Pipeline and sequence parallelism arrive with the
port's next parallel slice."""

from .mesh import make_mesh, multihost_initialize  # noqa: F401
from .sharding import (  # noqa: F401
    P,
    make_sharding_rules,
    mpq_column_parallel_spec,
    mpq_row_parallel_spec,
    partition_specs,
    shard_params,
)
