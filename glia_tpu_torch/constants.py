"""Framework-wide constants (the port's copy of glia_tpu.constants).

Mirror the reference's base definitions (code/glia_base.hxx:43-60,
code/glia_image.hxx:27-29) so that numeric semantics (safe division,
background/mask conventions) line up exactly with the reference.
"""

import numpy as np

# Label dtype: the reference uses uint32 (glia_base.hxx:43); labels are
# non-negative int32 here, as in glia_tpu.
LABEL_DTYPE = np.int32
REAL_DTYPE = np.float32
FVAL_DTYPE = np.float64  # feature values are double in the reference

# Background label (glia_image.hxx:27) - excluded from evaluation by default.
BG_VAL = 0
# Mask-out value (glia_image.hxx:28): pixels where mask == 0 are ignored.
MASK_OUT_VAL = 0
MASK_IN_VAL = 1

# Sentinel/dummy value (glia_base.hxx:56).
DUMMY = -1.0
# Float epsilon used for "is zero" tests and safe division (glia_base.hxx:57).
FEPS = 2.22e-16

# Sentinel label used for out-of-bounds neighbors in vectorized contour
# classification.  Must never collide with a real label; real labels are
# int32 >= 0.
OOB_LABEL = np.int32(-1)


def sdivide(lhs, rhs, dummy=0.0):
    """Safe division (glia_base.hxx:77-79): lhs/rhs if |rhs| >= FEPS else dummy.

    Works on scalars and numpy arrays.
    """
    if np.isscalar(rhs):
        return lhs / rhs if abs(rhs) >= FEPS else dummy
    rhs = np.asarray(rhs)
    safe = np.abs(rhs) >= FEPS
    out = np.divide(lhs, np.where(safe, rhs, 1.0))
    return np.where(safe, out, dummy)


def slog(x, dummy=0.0):
    """Safe natural log (glia_base.hxx:81): log(x) if x >= FEPS else dummy."""
    if np.isscalar(x):
        return np.log(x) if x >= FEPS else dummy
    x = np.asarray(x)
    safe = x >= FEPS
    return np.where(safe, np.log(np.where(safe, x, 1.0)), dummy)
