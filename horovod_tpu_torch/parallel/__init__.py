"""Parallelism over ``torch.distributed``: the port of
``horovod_tpu.parallel``.

Ported: the logical-axis layer (:mod:`~horovod_tpu_torch.parallel.
logical`: the axis vocabulary, ``LogicalMesh`` and its rules table) and
the mesh layer (:mod:`~horovod_tpu_torch.parallel.mesh`: rank-grid
meshes, the host topology, and the two-level intra-host / inter-host
ladder that the fused gradient buckets run under
``HOROVOD_HIERARCHICAL``); tensor parallelism
(:mod:`~horovod_tpu_torch.parallel.tp`: Megatron's column/row-parallel
layers and their conjugate collectives over a mesh's tensor axis);
sequence parallelism (:mod:`~horovod_tpu_torch.parallel.ring_attention`
and :mod:`~horovod_tpu_torch.parallel.ulysses`) and GPipe pipeline
parallelism (:mod:`~horovod_tpu_torch.parallel.pipeline`), over the
differentiable ``ppermute`` and all-to-all of
:mod:`~horovod_tpu_torch.parallel._collectives`; expert parallelism
(:mod:`~horovod_tpu_torch.parallel.moe`: Switch top-1 routing and the
all-to-all MoE layer); and the SPMD rank harness
(:mod:`~horovod_tpu_torch.parallel.spmd`).
"""

from horovod_tpu_torch.parallel.logical import (  # noqa: F401
    DATA_AXIS,
    DCN_AXIS,
    DEFAULT_RULES,
    ICI_AXIS,
    LogicalMesh,
    bind,
    current_logical_mesh,
    format_mesh_config,
    logical_partition_specs,
    module_axis,
    parse_mesh_config,
)
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    hierarchical_allreduce,
    hierarchical_mesh,
    make_mesh,
)
from horovod_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
)
from horovod_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
from horovod_tpu_torch.parallel.tp import (  # noqa: F401
    column_parallel,
    row_parallel,
    shard_columns,
    shard_rows,
    sum_across,
    tp_mlp,
    tp_region_input,
    tp_region_output,
    vocab_parallel_logits,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
)
from horovod_tpu_torch.parallel.moe import (  # noqa: F401
    moe_layer,
    top1_routing,
)
from horovod_tpu_torch.parallel.spmd import (  # noqa: F401
    P,
    PartitionSpec,
    axis_size,
    spmd,
    spmd_fn,
    spmd_run,
)
