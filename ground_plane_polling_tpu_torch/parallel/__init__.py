from .mesh import (
    data_parallel_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
)
from .distributed import (initialize, is_multi_host, local_batch_slice,
                          make_global_batch, make_global_raw_batch,
                          make_replicated)
