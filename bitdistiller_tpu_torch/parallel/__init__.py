"""Data, tensor and pipeline parallelism of the port (the JAX package's
`parallel`): process groups, per-rank data and point-to-point transfers
(`distributed`), the (dp, tp) mesh, the spec tables and each rank's slice
of a tree (`mesh`), Megatron's explicit tp collectives (`tensor`), the ring
matmuls (`overlap`), GPipe over the first pp ranks (`pipeline`), and the
ZeRO placement of the train state over dp (`zero`)."""

from .mesh import (
    batch_spec,
    make_mesh,
    packed_param_specs,
    param_specs,
    shard_params,
)
from .pipeline import (
    make_pp_mesh,
    pipeline_forward,
    pp_param_specs,
    shard_params_pp,
)

__all__ = [
    "batch_spec",
    "make_mesh",
    "packed_param_specs",
    "param_specs",
    "shard_params",
    "make_pp_mesh",
    "pipeline_forward",
    "pp_param_specs",
    "shard_params_pp",
]
