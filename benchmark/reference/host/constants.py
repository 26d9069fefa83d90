# Frozen copy of the label constants of glia_tpu_torch/constants.py at
# commit 28cc36d that the RAG's copy reads (the file's other constants and
# helpers left out: nothing here uses them).  Nothing here may import the
# program, so a later change to the program's copy does not move the
# yardstick.
"""Label constants (code/glia_image.hxx:27-29 of the reference)."""

import numpy as np

# Mask-out value (glia_image.hxx:28): pixels where mask == 0 are ignored.
MASK_OUT_VAL = 0

# Sentinel label used for out-of-bounds neighbors in vectorized contour
# classification.  Must never collide with a real label; real labels are
# int32 >= 0.
OOB_LABEL = np.int32(-1)
