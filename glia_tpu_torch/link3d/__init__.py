from .link import (
    gen_region_pairs,
    group_region_profiles,
    link_by_threshold,
    sc_features,
    sc_labels,
)
