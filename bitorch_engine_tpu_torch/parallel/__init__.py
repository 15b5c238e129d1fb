"""Parallel layouts over ``torch.distributed``: the counterpart of
``bitorch_engine_tpu/parallel`` (the process mesh, the sharding rules and
DiodeMix's moment specs, the collectives, the ring-overlapped row-parallel
MPQ product, ring and Ulysses sequence-parallel attention, the GPipe
pipeline and the process-world launcher)."""

from .mesh import make_axes_mesh, make_mesh, multihost_initialize  # noqa: F401
from .pipeline import pipeline_apply, stack_stages, stage_shardings  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
from .sharding import (  # noqa: F401
    P,
    make_sharding_rules,
    mpq_column_parallel_spec,
    mpq_row_parallel_spec,
    optimizer_partition_specs,
    partition_specs,
    shard_params,
)
from .ulysses import ulysses_attention  # noqa: F401
