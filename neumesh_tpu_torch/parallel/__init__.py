"""Multi-GPU training and serving (counterpart of neumesh_tpu/parallel/)
on torch.distributed: process bootstrap and rank helpers (dist), the
(batch x data) process grid, replicas and ray-axis sharding (mesh)."""
from . import dist
from .mesh import (ProcessGrid, ShardedGenerator, all_reduce_grads,
                   broadcast_params, get_device_mesh, get_global_mesh,
                   global_sum, make_global_batch, ray_sharder, replicate,
                   sharded_surface_render, sharded_volume_render)

__all__ = ["ProcessGrid", "ShardedGenerator", "all_reduce_grads",
           "broadcast_params", "dist", "get_device_mesh",
           "get_global_mesh", "global_sum", "make_global_batch",
           "ray_sharder", "replicate", "sharded_surface_render",
           "sharded_volume_render"]
