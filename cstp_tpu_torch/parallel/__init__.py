"""Data parallelism of the port over ``torch.distributed``."""

from cstp_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_rows,
    all_reduce_mean_,
    all_reduce_sum,
    average_buffers_,
    broadcast_object,
    create_mesh,
    distributed_run,
    global_moments,
    is_distributed,
    is_main,
    maybe_initialize_distributed,
    mean_metrics,
    rank,
    replicate,
    set_cross_rank_bn,
    shard_batch,
    shard_rows,
    shutdown,
    world_size,
)
