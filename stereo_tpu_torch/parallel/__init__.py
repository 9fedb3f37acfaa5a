"""The multi-device mesh (port of ``stereo_tpu/parallel``): the sharded
classical, DNN and single-view engines, the mesh and its placements, the
health probe, and the row split with its halo exchange that splits each
stereo network's rows over ``tile`` (``rows``)."""

from .classical import ShardedClassicalEngine
from .dnn import ShardedDnnEngine
from .mesh import (MESH_AXES, batch_sharding, image_row_sharding,
                   initialize_distributed, make_mesh, replicated)
from .synthesis import ShardedSingleViewEngine

__all__ = ["ShardedClassicalEngine", "ShardedDnnEngine",
           "ShardedSingleViewEngine", "MESH_AXES", "batch_sharding",
           "image_row_sharding", "initialize_distributed", "make_mesh",
           "replicated"]
