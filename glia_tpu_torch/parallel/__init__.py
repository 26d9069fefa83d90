from .halo import HaloPlan, make_halo_aggregate, make_halo_edge_forward
from .launch import spawn_ranks
from .merge_shard import (exact_saliency_sharded, merge_batched_sharded,
                          shard_merge_inputs)
from .mesh import EDGE_AXIS, Mesh, make_mesh
from .partition import Partition, partition_rag
from .rag_shard import make_region_aggregate, shard_edges
from .train import MLP_DIMS, edge_forward, make_train_step
