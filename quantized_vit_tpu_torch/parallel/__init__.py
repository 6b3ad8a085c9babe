"""Multi-process runtime (port of ``quantized_vit_tpu/parallel``, without
its TPU-only ``aot`` and ``audit``): the (dp, tp) process layout and the
partition rules (``partition``), the gloo bring-up, hybrid mesh, launchers
and health checks (``distributed``), the processes of one axis
(:class:`Peers`), the tensor-parallel serving collectives (``tp_comm``),
the quantized gradient collectives (``collectives``), the DP x TP QAT
step (``train_step``), sharded checkpoints (``sharded_ckpt``), elastic
recovery (``elastic``) and the GPipe forward (``pipeline``)."""

from .collectives import dp_all_reduce_grads, quantized_ring_all_reduce
from .distributed import (HealthCheckError, HealthReport, Workers,
                          assert_same_step, check_mesh,
                          collective_health_check, create_hybrid_mesh,
                          initialize_distributed, reinitialize_distributed,
                          run_processes)
from .elastic import elastic_restore, run_with_elastic_recovery, shrink_mesh
from .partition import (VIT_PARTITION_RULES, PartitionSpec, ProcessMesh,
                        create_mesh, data_sharding, gather_params,
                        partition_specs, shard_params, shard_vit_artifact,
                        spec_for_path)
from .peers import Peers
from .pipeline import (gpipe_blocks, stack_block_params,
                       unstack_block_params, vit_pipeline_forward)
from .sharded_ckpt import (restore_sharded_checkpoint,
                           save_sharded_checkpoint, scan_sharded_checkpoint)
from .tp_comm import (COLLECTIVES, all_gather_plain, reduce_scatter_plain,
                      reset_collectives)
from .train_step import (TrainState, gather_state, init_train_state,
                         logical_shards, loss_and_grads, train_step)

__all__ = [
    "elastic_restore",
    "run_with_elastic_recovery",
    "shrink_mesh",
    "dp_all_reduce_grads",
    "quantized_ring_all_reduce",
    "HealthCheckError",
    "HealthReport",
    "assert_same_step",
    "collective_health_check",
    "create_hybrid_mesh",
    "initialize_distributed",
    "create_mesh",
    "VIT_PARTITION_RULES",
    "spec_for_path",
    "partition_specs",
    "shard_params",
    "data_sharding",
    "restore_sharded_checkpoint",
    "save_sharded_checkpoint",
    "scan_sharded_checkpoint",
    "gpipe_blocks",
    "stack_block_params",
    "unstack_block_params",
    "vit_pipeline_forward",
    # the port's own
    "PartitionSpec",
    "ProcessMesh",
    "gather_params",
    "shard_vit_artifact",
    "Peers",
    "reinitialize_distributed",
    "run_processes",
    "Workers",
    "check_mesh",
    "COLLECTIVES",
    "reset_collectives",
    "all_gather_plain",
    "reduce_scatter_plain",
    "TrainState",
    "init_train_state",
    "loss_and_grads",
    "train_step",
    "logical_shards",
    "gather_state",
]
