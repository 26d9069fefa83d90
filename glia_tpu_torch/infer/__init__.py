from .ccm import (ccm_full_label_energies, ccm_node_marginal_energy,
                  compute_energy_tuples, node_energies, resolve_factor_tree,
                  segment_ccm_picks)
from .greedy import (resolve_tree_greedy, resolve_trees_greedy,
                     resolve_trees_greedy_subset)
from .segment import final_segmentation, relabel_image, transform_image
