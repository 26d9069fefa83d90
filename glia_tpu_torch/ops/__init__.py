from .neighbors import contour_traits, shifted_labels
from .pack import pack_csr_values, pack_edge_pixels
