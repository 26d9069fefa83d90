from .adv_shape import adv_shape_2d, hu_moments, region_centroids
from .config import FeatureConfig, HistImage
from .device import DeviceFeatureSpec, bc_features_dev, region_features_dev
from .hierarchical import TreeFeatures
from .labels import BC_LABEL_MERGE, BC_LABEL_SPLIT, bc_labels
from .serialize import bc_vector, boundary_vector, region_vector
