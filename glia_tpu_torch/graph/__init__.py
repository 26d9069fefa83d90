from .merge import apply_merge_order, greedy_merge_order
from .merge_bc_device import merge_order_bc_device
from .merge_device import (
    exact_saliency_device,
    greedy_merge_device,
    replay_exact_saliency,
    replay_exact_saliency_median,
    threshold_cut,
)
from .rag import Rag, build_rag
from .tree import MergeTree, build_tree, gen_merge_paths, node_potentials
