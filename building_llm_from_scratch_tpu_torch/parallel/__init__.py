"""Parallelism: the process group and the (data, seq, model) mesh, the
sharding rule table (dp / fsdp / zero1 / tp / tp_fsdp), the explicit
collectives, the tensor- and sequence-parallel forward's operators and
pipeline parallelism's (data, stage, model) mesh, plan and GPipe schedule
(port of the JAX package's ``parallel/``)."""

from building_llm_from_scratch_tpu_torch.parallel.collectives import (
    all_gather_into,
    all_reduce,
    broadcast_object,
    counters,
    gather_full,
    is_coordinator,
    reduce_scatter_into,
    reset_counters,
    sync_global_devices,
)
from building_llm_from_scratch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    initialize_distributed,
    make_mesh,
    shutdown_distributed,
)
from building_llm_from_scratch_tpu_torch.parallel.pipeline import (
    STAGE_AXIS,
    PipelinePlan,
    PPMesh,
    build_pp_plan,
    make_pp_mesh,
)
from building_llm_from_scratch_tpu_torch.parallel.sharding import (
    SHARD_MODES,
    MeshPlan,
    build_mesh_plan,
    spec_axis,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh", "initialize_distributed",
    "make_mesh", "shutdown_distributed", "SHARD_MODES", "MeshPlan",
    "build_mesh_plan", "spec_axis", "STAGE_AXIS", "PipelinePlan", "PPMesh",
    "build_pp_plan", "make_pp_mesh", "all_gather_into", "all_reduce",
    "broadcast_object", "counters", "gather_full", "is_coordinator",
    "reduce_scatter_into", "reset_counters", "sync_global_devices",
]
