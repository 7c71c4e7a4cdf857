from .sharded import ShardedHNSW, make_mesh  # noqa: F401
from .distributed import (  # noqa: F401
    ReplicatedServing, init_distributed, local_shard_mesh, replica_mesh)
