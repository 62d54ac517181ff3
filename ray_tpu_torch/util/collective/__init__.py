"""Actor-scoped collective communication (reference ``ray.util.collective``)."""

from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    GroupManager,
    ReduceOp,
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    object_store_available,
    recv,
    reduce,
    reducescatter,
    send,
)
