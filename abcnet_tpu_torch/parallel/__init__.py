from .mesh import (Mesh, all_reduce_sum, init_distributed, local_rows,
                   make_mesh, replicate_tree, shard_batch, sync_batchnorm)

__all__ = ["Mesh", "all_reduce_sum", "init_distributed", "local_rows",
           "make_mesh", "replicate_tree", "shard_batch", "sync_batchnorm"]
