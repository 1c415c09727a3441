from .mesh import (Mesh, all_reduce_sum, init_distributed, make_mesh,
                   replicate_tree, shard_batch, sync_batchnorm)

__all__ = ["Mesh", "all_reduce_sum", "init_distributed", "make_mesh",
           "replicate_tree", "shard_batch", "sync_batchnorm"]
