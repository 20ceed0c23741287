"""The parallel layer on torch.distributed: grids of ranks and their
collectives (mesh), Megatron sharding (sharding, tp), pipeline stages
(pp) and the sequence-parallel prefill (sp). One process per rank."""
from .mesh import (DATA_AXIS, MODEL_AXIS, initialize_multihost,
                   make_global_mesh, make_mesh, run_ranks, shard_for_process,
                   single_device_mesh)
from .sharding import (cache_specs, param_specs, replicate, shard_params,
                       shard_tree)
from .tp import (make_tp_eagle_forward, make_tp_forward,
                 make_tp_target_forward, shard_params_tp, tp_param_specs)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "initialize_multihost",
           "make_global_mesh", "make_mesh", "run_ranks", "shard_for_process",
           "single_device_mesh", "cache_specs", "param_specs", "replicate",
           "shard_params", "shard_tree", "make_tp_forward",
           "shard_params_tp", "tp_param_specs", "make_tp_target_forward",
           "make_tp_eagle_forward"]
