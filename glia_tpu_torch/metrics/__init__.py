from .rand import (
    adapted_rand_from_pairs,
    eval_ri,
    pair_f1_from_pairs,
    rand_index_from_pairs,
)
from .vi import eval_vi

__all__ = ["adapted_rand_from_pairs", "eval_ri", "eval_vi",
           "pair_f1_from_pairs", "rand_index_from_pairs"]
