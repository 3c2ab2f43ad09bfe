from vlsat_tpu_torch.parallel.mesh import (  # noqa: F401
    World,
    global_rand,
    global_sum,
    init_data_parallel,
    reducing,
    replicate,
    shard_batch,
    shard_eval_batches,
    shard_stacked_batch,
    shutdown,
    spawn_ranks,
    world,
)
