"""Label / real image IO (a copy of glia_tpu.io.image, plus ``.npy``).

The reference reads and writes images through ITK (code/util/image_io.hxx).
Here PNG/TIFF is handled via imageio; arrays are numpy with shape (H, W)
for 2D and (Z, H, W) for 3D.  Axis convention: the ITK index dimension 0
(fastest-varying, "x") corresponds to the LAST numpy axis, so a raster
traversal of the numpy array visits pixels in the same order as an ITK
ImageRegionConstIterator.

Paths ending in ``.npy`` are read and written with numpy, with the array's
dtype kept, so the file bus runs where imageio is not installed; every
other suffix goes through imageio, as in glia_tpu.
"""

from __future__ import annotations

import numpy as np


def _is_npy(path) -> bool:
    return str(path).endswith(".npy")


def read_image(path, dtype=None):
    if _is_npy(path):
        arr = np.load(path)
    else:
        import imageio.v3 as iio

        arr = np.asarray(iio.imread(path))
    if dtype is not None:
        arr = arr.astype(dtype)
    return arr


def write_image(path, arr):
    if _is_npy(path):
        np.save(path, np.asarray(arr))
        return
    import imageio.v3 as iio

    iio.imwrite(path, np.asarray(arr))


def read_label_image(path):
    return read_image(path).astype(np.int32)


def read_real_image(path, normalize=False):
    arr = read_image(path).astype(np.float32)
    if normalize and arr.max() > 1.0:
        arr = arr / 255.0
    return arr
