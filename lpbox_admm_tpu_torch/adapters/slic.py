"""SLIC superpixel segmentation (numpy, no skimage dependency).

The port's own copy of the JAX package's ``adapters/slic.py`` (that
module is numpy only, but the port imports nothing of that package);
its label maps are the JAX package's, bit for bit.

The reference calls ``skimage.segmentation.slic(image, n_segments=150,
compactness=10)`` once per image to build the group-sparsity masks B
(SparseAttack/SparseAttack/main_mha.py:132-160).  skimage is not
available in this environment, so this is a standard SLIC
implementation (Achanta et al. 2012): grid-seeded cluster centres in
(lab, x, y) space, local k-means with combined distance
``d_lab + (compactness/S) * d_xy``, a fixed number of iterations, and a
simple connectivity-free labelling (sufficient for mask construction --
the attack only needs a pixel partition).
"""

from __future__ import annotations

import numpy as np


def _rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8/float RGB -> CIELAB (approximate, D65)."""
    rgb = np.asarray(rgb, dtype=np.float64)
    if rgb.max() > 1.0:
        rgb = rgb / 255.0
    # linearize sRGB
    mask = rgb > 0.04045
    lin = np.where(mask, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    M = np.array([[0.4124564, 0.3575761, 0.1804375],
                  [0.2126729, 0.7151522, 0.0721750],
                  [0.0193339, 0.1191920, 0.9503041]])
    xyz = lin @ M.T
    white = np.array([0.95047, 1.0, 1.08883])
    xyz = xyz / white

    def f(t):
        return np.where(t > (6 / 29) ** 3, np.cbrt(t),
                        t / (3 * (6 / 29) ** 2) + 4 / 29)

    fx, fy, fz = f(xyz[..., 0]), f(xyz[..., 1]), f(xyz[..., 2])
    L = 116 * fy - 16
    a = 500 * (fx - fy)
    b = 200 * (fy - fz)
    return np.stack([L, a, b], axis=-1)


def slic(image: np.ndarray, n_segments: int = 150,
         compactness: float = 10.0, n_iter: int = 10) -> np.ndarray:
    """Segment an (H, W, 3) image into ~n_segments superpixels.

    Returns an (H, W) int label map with labels in [0, K).
    """
    H, W = image.shape[:2]
    lab = _rgb_to_lab(image)
    S = max(int(round(np.sqrt(H * W / n_segments))), 1)

    # grid-seeded centres
    ys = np.arange(S // 2, H, S)
    xs = np.arange(S // 2, W, S)
    centers = []
    for y in ys:
        for x in xs:
            centers.append([lab[y, x, 0], lab[y, x, 1], lab[y, x, 2],
                            float(y), float(x)])
    centers = np.array(centers)
    K = len(centers)

    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    feats = np.concatenate(
        [lab.reshape(-1, 3),
         yy.reshape(-1, 1).astype(np.float64),
         xx.reshape(-1, 1).astype(np.float64)], axis=1)

    ratio = (compactness / S) ** 2
    labels = np.zeros(H * W, dtype=np.int64)
    dists = np.full(H * W, np.inf)

    for _ in range(n_iter):
        dists[:] = np.inf
        for k in range(K):
            cy, cx = int(centers[k, 3]), int(centers[k, 4])
            y0, y1 = max(0, cy - 2 * S), min(H, cy + 2 * S + 1)
            x0, x1 = max(0, cx - 2 * S), min(W, cx + 2 * S + 1)
            idx = (yy[y0:y1, x0:x1] * W + xx[y0:y1, x0:x1]).ravel()
            fpatch = feats[idx]
            d_lab = np.sum((fpatch[:, :3] - centers[k, :3]) ** 2, axis=1)
            d_xy = np.sum((fpatch[:, 3:] - centers[k, 3:]) ** 2, axis=1)
            d = d_lab + ratio * d_xy
            better = d < dists[idx]
            dists[idx[better]] = d[better]
            labels[idx[better]] = k
        # update centres
        for k in range(K):
            sel = labels == k
            if sel.any():
                centers[k] = feats[sel].mean(axis=0)

    # compact label ids
    uniq, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(H, W)


def segment_masks(image: np.ndarray, n_segments: int = 150,
                  compactness: float = 10.0,
                  channels: int = 3) -> np.ndarray:
    """Build the group-sparsity masks B of shape (K, C, H, W): mask k is
    1 on the pixels (all channels) of superpixel k
    (main_mha.py:151-157)."""
    seg = slic(image, n_segments=n_segments, compactness=compactness)
    K = seg.max() + 1
    H, W = seg.shape
    B = np.zeros((K, channels, H, W), dtype=np.float32)
    for k in range(K):
        B[k, :, seg == k] = 1.0
    return B
