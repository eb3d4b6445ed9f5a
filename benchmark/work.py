"""The benchmark's yardstick for kernels: the work each one does, counted
from the shapes and the iterations run, the peaks it is held against,
and the names its kernels carry in a device trace.

The work is the algorithm's, not an implementation's: the products an
ADMM iteration or a policy forward needs on each instance's true sizes
(its valid rows and its free columns, not the padding), the iterations
each instance really ran, every input byte read once and every output
byte written once.  The least time of a launch is the larger of its
bytes over the memory bandwidth and its operations over the fastest
rate at which an implementation that passes the cell's check could do
them (see PEAKS).  A share of that least time over the measured kernel
time cannot pass 100% unless the work is counted too high.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W
HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12
INT8_OPS = 1979e12
#: The fastest rate for each kind of product that passes the cell's
#: check, by the argument K2's is made with: one TF32 pass (10-bit
#: mantissa) already misses the check's limits on a float32 operand
#: (the control, ``reference.tf32``, is exactly that and must fail), and
#: every split that carries enough bits is slower than one TF32 pass,
#: so one TF32 pass bounds them all from above.
#: * ``dense``: a float32 matrix on both sides (G^-1, H^-1, the policy's
#:   weights): 495 TFLOP/s, TF32 dense.
#: * ``exact``: a small-integer matrix (CA's 0/1 E, E_f^T E_f) against a
#:   float32 vector.  The matrix is exact in int8; the vector needs more
#:   than 8 bits (one TF32 pass, 11 bits, fails), so at least two int8
#:   limbs: 1979 / 2 TOP/s.  No implementation that passes does better.
PEAKS = {"dense": TF32_FLOPS, "exact": INT8_OPS / 2}

#: substrings of the kernel names in a device trace, per kernel
KERNELS = {"k1": ("lp_window_kernel",),
           "k2": ("policy_encoder_kernel", "policy_classifier_kernel")}


def least_time(exact_flops: float, dense_flops: float, nbytes: float):
    """(seconds, bound): the larger of the operations' time at their
    peaks (the two kinds run one after the other on the same tensor
    cores, so their times add) and the bytes over the bandwidth."""
    t_ops = exact_flops / PEAKS["exact"] + dense_flops / PEAKS["dense"]
    t_mem = nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def strided(it0, iters, stride: int):
    """How many of the iterations it0 .. it0 + iters - 1 sample the
    incumbent (every ``stride``-th global iteration)."""
    iters = np.asarray(iters, np.int64)
    if stride <= 1:
        return iters
    last = it0 + iters - 1
    return np.where(iters > 0, last // stride - (it0 - 1) // stride, 0)


def k1_launch(m_i, n_i, iters_i, strided_i, nside: bool, record_steps: int):
    """Work of one K1 window over a batch (arrays over instances i):
    ``m_i`` valid rows, ``n_i`` free columns, ``iters_i`` iterations run
    (a done instance runs none), ``strided_i`` of them sampling the
    incumbent.

    An m-side iteration needs 5 products with E (E^T w, E rhs, E^T u,
    E x0, E^T E x0) and one with the m x m factor; an n-side one 2 with E
    (E^T w, E x), one with the n x n factor and one with E_f^T E_f; an
    incumbent sample one more with E.  2 flops a multiply-add.  Bytes,
    of the instances that iterate: E (one byte an entry: 0/1) and E_f^T
    E_f (small integers), the factor in float32, the vectors in and out,
    a recorded trajectory.  Returns (exact_flops, dense_flops, bytes)."""
    m = np.asarray(m_i, np.float64)
    n = np.asarray(n_i, np.float64)
    it = np.asarray(iters_i, np.float64)
    inc = np.asarray(strided_i, np.float64)
    mn = m * n
    if nside:
        exact = 2.0 * (it * (2 * mn + n * n) + inc * mn)
        dense = 2.0 * it * n * n
        fac = 4.0 * n * n + n * n
    else:
        exact = 2.0 * (it * 5 * mn + inc * mn)
        dense = 2.0 * it * m * m
        fac = 4.0 * m * m
    vectors = 4.0 * (11 * n + 7 * m)     # state in and out, b, f, masks
    nbytes = (mn + fac + vectors + 4.0 * n * record_steps) * (it > 0)
    return float(exact.sum()), float(dense.sum()), float(nbytes.sum())


def k2_launch(rows: int, ws: int, T: int, C: int, E: int, L: int, F: int,
              hidden=(256, 128, 16)):
    """Work of one policy scoring of ``rows`` trajectory rows: per row T
    tokens of C values embedded to E, L layers of attention (q, k, v and
    out projections, the T x T scores and mix) and a feed-forward of
    width F, then the classifier over T*E -> 256 -> 128 -> 16 -> 1.
    All products are ``dense``.  Bytes: the rows and the scores once, the
    weights once.  Returns (exact_flops, dense_flops, bytes)."""
    h1, h2, h3 = hidden
    fma = T * C * E + L * (T * E * 3 * E + 2 * T * T * E + T * E * E
                           + 2 * T * E * F) \
        + T * E * h1 + h1 * h2 + h2 * h3 + h3
    weights = (C * E + T * E + L * (4 * E * E + 2 * E * F + 5 * E + F)
               + T * E * h1 + h1 + h1 * h2 + h2 + h2 * h3 + h3 + h3 + 1)
    nbytes = 4.0 * (rows * ws + rows + weights)
    return 0.0, 2.0 * fma * rows, nbytes
