from .image import read_image, read_label_image, read_real_image, write_image
from .text import (
    read_matrix,
    read_merge_order,
    read_vector,
    write_matrix,
    write_merge_order,
    write_vector,
)
