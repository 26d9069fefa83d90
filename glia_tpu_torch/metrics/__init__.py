from .contingency import contingency_table, pair_stats, pair_stats_from_counts
from .rand import (
    adapted_rand_from_pairs,
    eval_ri,
    pair_f1_from_pairs,
    rand_index_from_pairs,
)
from .vi import centropy, eval_vi, vi_image, vi_region_sets

__all__ = [
    "contingency_table",
    "pair_stats",
    "pair_stats_from_counts",
    "adapted_rand_from_pairs",
    "eval_ri",
    "pair_f1_from_pairs",
    "rand_index_from_pairs",
    "centropy",
    "eval_vi",
    "vi_image",
    "vi_region_sets",
]
