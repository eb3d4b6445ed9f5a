"""Image segmentation adapter: image -> pixel-grid binary QP (the port of
the JAX package's ``adapters/segmentation.py``; reference
Segmentation/Segmentation/cython/src/image_segmentation_utils.cpp and
the inlined copy in Seg LPboxADMMsolver.cpp:658-810):

* ``load_image``: grayscale load and area-preserving resize to about
  ``num_nodes`` pixels, intensities scaled by 1/263 (Seg :705-727);
* ``unary_cost`` (``get_unary_cost``, utils.cpp:15-41): Gaussian
  log-likelihood fg/bg potentials, sigma 0.1, b 0.6, f1 = f2 = 0.2,
  rounded;
* ``binary_weights`` (``get_binary_cost``, utils.cpp:134-184): neighbour
  affinities round(3 exp(-(Ii - Ij)^2 / sigma_img)), sigma_img the
  sample std of the image;
* ``image_to_qp`` (``get_A_b_from_cost``, utils.cpp:186-208): b = U2 -
  U1, A' = D - W stored as stencil planes (the reference stores A/2,
  Seg :751-758), constant c = sum U1.

The cost construction is host float64 numpy, as in the JAX package; the
problem goes to ``device`` (the card unless the caller asks for the
CPU).  The JAX package's documented departures from reference quirks
are kept: the full 8-neighbour grid (the reference's pair generator
drops the diagonal directions and mixes index orders, utils.cpp:115,
150-152).

PIL is imported by ``load_image`` and ``save_img`` alone: without it
those two raise ``ImportError`` and everything else runs.  An image
stored as ``.npy`` (an (H, W) array of intensities already divided by
263, taken as it is) loads without PIL: that is how ``chip_smoke.py``
drives ``experiments.run_seg`` on a machine without PIL.
"""

from __future__ import annotations

import glob
import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.problem import Device, as_device
from ..core.qp import QpProblem
from ..ops.stencil import OFFSETS, build_stencil


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading or writing segmentation images needs PIL (the "
            "'pillow' package); every other function of "
            "adapters.segmentation runs without it") from e
    return Image


def load_image(path: str, num_nodes: int = 10_000) -> np.ndarray:
    """Grayscale load + bilinear resize so that H*W ~= num_nodes,
    intensities / 263 (Seg LPboxADMMsolver.cpp:705-727); a ``.npy``
    file is read as the finished (H, W) float64 intensities."""
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=False).astype(np.float64)
    Image = _pil_image()
    img = Image.open(path).convert("L")
    w, h = img.size
    scale = math.sqrt(num_nodes / float(w * h))
    img = img.resize((round(scale * w), round(scale * h)), Image.BILINEAR)
    return np.asarray(img, dtype=np.float64) / 263.0


def unary_cost(I: np.ndarray, sigma: float = 0.1, b: float = 0.6,
               f1: float = 0.2, f2: float = 0.2
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian fg/bg unary potentials (utils.cpp:15-41), rounded as in
    the solver (Seg :744): (alpha_b, alpha_f) = (U1, U2)."""
    c = math.log(2.0 * math.pi) / 2.0 + math.log(sigma)
    alpha_b = (I - b) ** 2 / (2 * sigma * sigma) + c
    aa = (np.exp(-(I - f1) ** 2 / (2 * sigma * sigma))
          + np.exp(-(I - f2) ** 2 / (2 * sigma * sigma)))
    alpha_f = -np.log(aa + np.finfo(np.float64).eps) + c + math.log(2.0)
    return np.round(alpha_b), np.round(alpha_f)


def binary_weights(I: np.ndarray, lam: float = 3.0) -> np.ndarray:
    """8-neighbour affinity planes (8, H, W): round(lam exp(-(Ii - Ij)^2
    / sigma_img)), sigma_img the sample std of the intensities
    (utils.cpp:134-160); 0 toward out-of-grid neighbours."""
    H, W = I.shape
    sigma = float(np.std(I, ddof=1))
    planes = np.zeros((8, H, W))
    for d, (dr, dc) in enumerate(OFFSETS):
        shifted = np.full((H, W), np.nan)
        r0, r1 = max(0, -dr), min(H, H - dr)
        c0, c1 = max(0, -dc), min(W, W - dc)
        shifted[r0:r1, c0:c1] = I[r0 + dr:r1 + dr, c0 + dc:c1 + dc]
        w = np.round(lam * np.exp(-(I - shifted) ** 2 / sigma))
        planes[d] = np.where(np.isnan(shifted), 0.0, w)
    return planes


def image_to_qp(I: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """One image's costs: (weights (8, H, W) of A' = D - W, linear b
    (H, W), constant c), with A stored /2 as the reference does (org_A =
    _A/2, Seg :751-758): _A = 2(D - W), so A' = D - W; b = U2 - U1; c =
    sum U1."""
    U1, U2 = unary_cost(I)
    return binary_weights(I), U2 - U1, float(U1.sum())


def make_problem(images: Sequence[np.ndarray],
                 h_pad: Optional[int] = None, w_pad: Optional[int] = None,
                 align: bool = False, dtype=np.float32,
                 device: Device = "cuda") -> QpProblem:
    """Batch images of (possibly) different sizes into one padded grid
    QP on ``device``; padded pixels have zero weights and costs and mask
    False.  ``align=True`` pads H to a multiple of 8 and W to one of 128
    (the JAX package's TPU tile alignment, kept as an option)."""
    dev = as_device(device)
    B = len(images)
    H = h_pad or max(im.shape[0] for im in images)
    W = w_pad or max(im.shape[1] for im in images)
    if align:
        H = ((H + 7) // 8) * 8
        W = ((W + 127) // 128) * 128
    weights = np.zeros((B, 8, H, W), dtype=dtype)
    bs = np.zeros((B, H, W), dtype=dtype)
    consts = np.zeros((B,), dtype=dtype)
    mask = np.zeros((B, H, W), dtype=bool)
    for i, im in enumerate(images):
        wi, bi, ci = image_to_qp(im)
        h, w = im.shape
        weights[i, :, :h, :w] = wi
        bs[i, :h, :w] = bi
        consts[i] = ci
        mask[i, :h, :w] = True
    t = lambda a: torch.from_numpy(a).to(dev)
    return QpProblem(stencil=build_stencil(t(weights)), b=t(bs),
                     const=t(consts), mask=t(mask))


def load_problem(paths: Sequence[str], num_nodes: int = 10_000,
                 **kw) -> QpProblem:
    """``make_problem`` of the images at ``paths`` (needs PIL)."""
    return make_problem([load_image(p, num_nodes) for p in paths], **kw)


#: where ``reference_image_paths`` looks without a ``root``: the
#: reference's Segmentation/Segmentation/cython/data under a checkout of
#: the reference beside this repository's package
REFERENCE_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "reference", "Segmentation", "Segmentation", "cython", "data")


def reference_image_paths(root: Optional[str] = None) -> List[str]:
    """The images shipped with the reference ({i}.jpg) under ``root``
    (default: ``$LPBOX_SEG_IMAGES``, else ``REFERENCE_DATA``), in
    numeric order; an empty list where there are none."""
    root = root or os.environ.get("LPBOX_SEG_IMAGES") or REFERENCE_DATA
    return sorted(glob.glob(os.path.join(root, "*.jpg")),
                  key=lambda p: int(os.path.splitext(
                      os.path.basename(p))[0]))


def save_img(solution: np.ndarray, mask: np.ndarray, path: str,
             orig_shape: Optional[Tuple[int, int]] = None):
    """Threshold at 0.5 -> {0, 255} PNG (save_img, Seg :812-837) of one
    (H, W) grid, padding cut to ``orig_shape`` when given (needs PIL)."""
    Image = _pil_image()
    img = (np.asarray(solution) >= 0.5).astype(np.uint8) * 255
    if orig_shape is not None:
        img = img[:orig_shape[0], :orig_shape[1]]
    Image.fromarray(img, mode="L").save(path)
