"""Image operations (the reference's gadget image-op surface; a copy of
glia_tpu.ops.image).

Equivalents of code/util/image.hxx utilities used by the gadget binaries
(SURVEY.md section 2.7): threshold, blur, crop, resample, max-pool,
accumulate, relabel, dilate-background, BSDS-style boundary raster,
tile/stack/extract.  Arrays in, arrays out; 2D and 3D.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi

from ..constants import BG_VAL, MASK_OUT_VAL


def threshold_image(image, lower, upper, inside=1, outside=0):
    """BinaryThreshold (image.hxx:263-279): inside iff lower <= v <= upper."""
    image = np.asarray(image)
    return np.where((image >= lower) & (image <= upper), inside,
                    outside).astype(np.asarray(inside).dtype
                                    if np.ndim(inside) else type(inside))


def blur_image(image, sigma, slicewise=False):
    """Gaussian blur; slicewise blurs each z-slice independently
    (image.hxx:376-407)."""
    image = np.asarray(image, dtype=np.float32)
    if slicewise and image.ndim == 3:
        return np.stack([ndi.gaussian_filter(s, sigma) for s in image])
    return ndi.gaussian_filter(image, sigma)


def crop_image(image, origin, size):
    sl = tuple(slice(o, o + s) for o, s in zip(origin, size))
    return np.asarray(image)[sl].copy()


def resample_image(image, factor, order=1):
    """Resample by zoom factor(s); order=0 for label images."""
    return ndi.zoom(np.asarray(image), factor, order=order)


def max_pool_image(image, skip_dims=()):
    """2x block max pooling with ceil edges (image.hxx:553-598); dims in
    skip_dims keep their size."""
    image = np.asarray(image)
    out = image
    for ax in range(image.ndim):
        if ax in skip_dims:
            continue
        n = out.shape[ax]
        pad = [(0, 0)] * out.ndim
        if n % 2:
            pad[ax] = (0, 1)
            edge = np.take(out, [-1], axis=ax)
            out = np.concatenate([out, edge], axis=ax)
        s0 = [slice(None)] * out.ndim
        s1 = [slice(None)] * out.ndim
        s0[ax] = slice(0, None, 2)
        s1[ax] = slice(1, None, 2)
        out = np.maximum(out[tuple(s0)], out[tuple(s1)])
    return out


def accumulate_images(images, average=False):
    """acc_images: pointwise sum (or mean) of images (image.hxx:602-642)."""
    acc = np.zeros_like(np.asarray(images[0], dtype=np.float64))
    for im in images:
        acc += np.asarray(im, dtype=np.float64)
    if average:
        acc /= len(images)
    return acc


def dilate_background(labels, mask=None):
    """Fill BG pixels with the smallest (original-size) neighboring label,
    iterating rounds until no BG pixel has a labeled neighbor
    (image.hxx:884-938).  Sizes are frozen at the start."""
    labels = np.asarray(labels).copy()
    if mask is not None:
        inside = np.asarray(mask) != MASK_OUT_VAL
    else:
        inside = np.ones(labels.shape, dtype=bool)
    uniq, counts = np.unique(labels[inside & (labels != BG_VAL)],
                             return_counts=True)
    size_of = dict(zip(uniq.tolist(), counts.tolist()))
    # rank labels by (size, never BG); smaller size wins
    rank = {k: (v, k) for k, v in size_of.items()}

    def neighbor_stacks(arr):
        outs = []
        for ax in range(arr.ndim):
            for shift in (1, -1):
                sh = np.roll(arr, shift, axis=ax)
                idx = [slice(None)] * arr.ndim
                idx[ax] = 0 if shift == 1 else -1
                sh[tuple(idx)] = BG_VAL
                outs.append(sh)
        return outs

    while True:
        bg = (labels == BG_VAL) & inside
        if not bg.any():
            break
        nbrs = neighbor_stacks(np.where(inside, labels, BG_VAL))
        # smallest-size neighboring label per pixel
        best = np.full(labels.shape, BG_VAL, dtype=labels.dtype)
        best_size = np.full(labels.shape, np.iinfo(np.int64).max)
        for nb in nbrs:
            sz = np.full(labels.shape, np.iinfo(np.int64).max)
            present = nb != BG_VAL
            if present.any():
                lut_max = int(nb.max()) + 1
                lut = np.full(lut_max, np.iinfo(np.int64).max)
                for k, v in size_of.items():
                    if k < lut_max:
                        lut[k] = v
                sz = np.where(present, lut[np.maximum(nb, 0)], sz)
            better = sz < best_size
            best = np.where(better, nb, best)
            best_size = np.where(better, sz, best_size)
        fill = bg & (best != BG_VAL)
        if not fill.any():
            break
        labels[fill] = best[fill]
    return labels


def boundary_image_2d(labels, image=None):
    """BSDS-style double-size boundary raster (image.hxx:735-880):
    output (2H, 2W) where odd-coordinate pixels between differing
    neighbors are boundary (1), else 0."""
    labels = np.asarray(labels)
    h, w = labels.shape
    out = np.zeros((2 * h, 2 * w), dtype=np.uint8)
    dx = labels[:, :-1] != labels[:, 1:]
    dy = labels[:-1, :] != labels[1:, :]
    out[::2, 1:-1:2] = dx
    out[1:-1:2, ::2] = dy
    # corner points: boundary if any adjacent boundary edge
    out[1:-1:2, 1:-1:2] = (dx[:-1, :] | dx[1:, :] | dy[:, :-1] | dy[:, 1:])
    return out


def stack_images(slices):
    """2D slices -> 3D volume (image.hxx:1030-1060)."""
    return np.stack([np.asarray(s) for s in slices])


def extract_slice(volume, index, axis=0):
    return np.take(np.asarray(volume), index, axis=axis)


def image_patches(image, patch_size, stride):
    """gen_image_patches: sliding window patches (image.hxx:963-988)."""
    image = np.asarray(image)
    ph, pw = patch_size
    sh, sw = stride
    out = []
    for i in range(0, image.shape[0] - ph + 1, sh):
        for j in range(0, image.shape[1] - pw + 1, sw):
            out.append(image[i:i + ph, j:j + pw])
    return np.stack(out) if out else np.zeros((0, ph, pw), image.dtype)


def slicewise_connected_components(volume):
    """Per-slice CC with globally unique labels (3D linking utility)."""
    from ..native import connected_components_native

    out = np.zeros_like(np.asarray(volume), dtype=np.int32)
    offset = 0
    for z in range(volume.shape[0]):
        cc = connected_components_native(np.asarray(volume[z], np.int32))
        n = int(cc.max())
        out[z] = np.where(cc > 0, cc + offset, 0)
        offset += n
    return out


def scalar_connected_components(image, diff_threshold=0):
    """Connected components where ADJACENT pixels within ``diff_threshold``
    of each other join (gadget/main_labelscc_image.cxx via ITK's
    ScalarConnectedComponentImageFilter; util/image.hxx:315-326).  Every
    pixel is labeled (no background), labels from 1; 2*D connectivity.
    """
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg

    img = np.asarray(image)
    n = img.size
    idx = np.arange(n).reshape(img.shape)
    rows, cols = [], []
    for d in range(img.ndim):
        sl_a = [slice(None)] * img.ndim
        sl_b = [slice(None)] * img.ndim
        sl_a[d] = slice(None, -1)
        sl_b[d] = slice(1, None)
        a = idx[tuple(sl_a)].ravel()
        b = idx[tuple(sl_b)].ravel()
        flat = img.ravel()
        ok = np.abs(flat[a].astype(np.float64)
                    - flat[b].astype(np.float64)) <= diff_threshold
        rows.append(a[ok])
        cols.append(b[ok])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    g = sp.coo_matrix((np.ones(len(r), np.int8), (r, c)), shape=(n, n))
    _, labels = csg.connected_components(g, directed=False)
    return (labels + 1).astype(np.int32).reshape(img.shape)


def identity_connected_components(labels, mask=None):
    """Relabel connected components of EQUAL-label pixels; BG_VAL pixels
    and masked-out pixels stay background (labelIdentityConnectedComponents,
    util/image.hxx:329-377; gadget/main_labelicc_image.cxx)."""
    from ..constants import BG_VAL, MASK_OUT_VAL
    from ..native import connected_components_native

    lab = np.asarray(labels, dtype=np.int32)
    m = (lab != BG_VAL).astype(np.int32)
    if mask is not None:
        m &= (np.asarray(mask) != MASK_OUT_VAL).astype(np.int32)
    return connected_components_native(lab, mask=m)


def sample_image(image, stride):
    """Strided subsampling (image.hxx:686-727 sampleImage)."""
    sl = tuple(slice(None, None, s) for s in
               (stride if hasattr(stride, "__len__")
                else (stride,) * np.asarray(image).ndim))
    return np.asarray(image)[sl].copy()


def tile_images(images, cols):
    """Arrange equally-sized 2D images into a grid (image.hxx tileImages)."""
    images = [np.asarray(im) for im in images]
    h, w = images[0].shape[:2]
    rows = (len(images) + cols - 1) // cols
    out = np.zeros((rows * h, cols * w) + images[0].shape[2:],
                   dtype=images[0].dtype)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        out[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return out


def overlay_image(image, labels, alpha=0.5, seed=0):
    """Colorized label overlay for inspection (gadget/main_overlay_image)."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    n = int(labels.max()) + 1
    colors = rng.random((n, 3))
    rgb = colors[labels]
    base = np.asarray(image, dtype=np.float64)
    if base.ndim == 2:
        base = base[..., None].repeat(3, axis=-1)
    base = base / max(base.max(), 1e-6)
    return (1 - alpha) * base + alpha * rgb


def skeletonize_image(binary):
    """2D binary thinning to a 1-pixel-wide, connectivity-preserving
    skeleton (capability of image.hxx:646-655, which wraps ITK's
    BinaryThinningImageFilter; unused by any reference pipeline stage).

    Zhang-Suen thinning, fully vectorized: each sub-iteration evaluates
    the neighbor-count / transition-count / directional-neighbor rules on
    all pixels at once and peels one layer; repeats until stable.
    """
    img = (np.asarray(binary) != 0).astype(np.uint8)
    if img.ndim != 2:
        raise ValueError("skeletonize_image is 2D-only (like the reference)")

    def neighbors(a):
        p = np.pad(a, 1)
        # p2..p9 clockwise from north (Zhang-Suen convention)
        return [p[:-2, 1:-1], p[:-2, 2:], p[1:-1, 2:], p[2:, 2:],
                p[2:, 1:-1], p[2:, :-2], p[1:-1, :-2], p[:-2, :-2]]

    while True:
        changed = False
        for step in (0, 1):
            nb = neighbors(img)
            b = sum(n.astype(np.int32) for n in nb)
            seq = nb + [nb[0]]
            a = sum(((seq[i] == 0) & (seq[i + 1] == 1)) for i in range(8))
            p2, p4, p6, p8 = nb[0], nb[2], nb[4], nb[6]
            if step == 0:
                cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
            else:
                cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
            kill = (img == 1) & (a == 1) & (b >= 2) & (b <= 6) & cond
            if kill.any():
                img[kill] = 0
                changed = True
        if not changed:
            return img
