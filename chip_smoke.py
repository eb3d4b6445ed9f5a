#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is the CA-500 learned-early-fixing solve: 128
combinatorial-auction instances (100 items x 500 bids, seed 2207,
padded to (m, n) = (256, 512)) solved plain with the fused LP window
(incumbent stride 8, 16 repair + 4 swap rounds), then with
``l2f_solve_compact`` and the shipped ``ca500_mha`` checkpoint at the
operating point of the JAX package's bench (fix confidence 0.98,
2-window streaks, damage gate 0.25, 3 policy windows of 100, rho boost
5000, max_iter 10000).

Then training: the port's training entry point
(``lpbox_admm_tpu_torch.scripts.train_ca500_policy.main``) at full width
(the ``ca500_mha`` network: 20 tokens of 5, embed 128, 8 heads, 2 MHA
layers, FF 512) on 8 + 8 CA-500 instances it makes itself, 2 epochs and
its masked evaluation (K2); the shipped checkpoint resumed with its Adam
state for 5 steps on a 40 960-row episode batch; the compacting
evaluation of that policy (K1 and K2); one step on the card against the
same step on the CPU; the checkpoint written in the JAX package's format
and read back into K2.

Then data parallelism over instances (``parallel.mesh``; the ``dp``
phase, after training): a world-1 NCCL group in this process solves the
sharded CA-500 batch with K1 and gathers it back, bit for bit the main
path's plain solve; two gloo ranks on the one card (spawned, with a
deadline), 64 instances each, run the plain K1 solve (gathered: the bits
of each shard solved alone in this process; K1's clusters follow a
launch's live count, so a shard's bits are its own, not the batch's),
the l2f solve (K1, K2: the main path's fixes per instance, each shard's
objectives and gap its own one-process solve's) and one training step
at full width on 20 480
rows each (the one-process step's loss and gradient, the same weights on
both ranks), with two planted faults (BatchNorm over each rank's rows,
each rank's loss over its own rows) that must cross the step's bound;
``dp_scaling_table`` at one rank.

The batched-matvec probe (``lpbox_admm_tpu_torch.scripts.probe_dot``,
the port of the JAX package's ``scripts/probe_dot.py``): its three
formulations P1-P3 at (8, 256, 256) through the entry point's own
functions; the kernels are also checked and timed at (8, 1664, 4096),
each beside ``torch.bmm``, with the host's enqueue time per call.

Then the large-rung path: the reference's xl CA instance (800 items x
4000 bids), 32 instances padded to (m, n) = (1664, 4096), solved by the
blocked single-stream solve (``core.lp.solve_blocked(stream=True)``,
bf16 E, blocks of 8, windows of 500, 9000 iterations) with K3 the sweep
and, on the packed-symmetric G^{-1} route, K4; and by
``l2f_solve_compact`` at the CA-500 operating point, whose policy phase
records with ``core.lp`` windows (K1 cannot hold that shape) and whose
tail runs in K1 when the compacted bucket fits it.

The dense-LP options of ``core.lp`` on the CA-500 batch: the
three-limb bfloat16 products (E v, E^T w, G^{-1} r) against float32 on
the card, with a one-limb product as a planted fault; the bfloat16 store
of G^{-1}; ``solve(rule_fixing=True)`` on 8 instances; ``solve_auto``,
which must take K1 and give the plain solve's objective bit for bit.

Then the segmentation workload (the paper's second): 8 synthetic images
at 100 x 100 and 8 at 316 x 316 (``seg_images``: smoothed Gaussian
random fields, quantised as the reference's loader quantises), each
batch solved plain (``build_dataset_qp``, polished by 8 one-flip and 4
domino sweeps, with a profile of a grid QP iteration) and by the masked
``l2f_solve`` and the compacting ``l2f_solve_compact_qp`` with the
shipped ``seg_mha`` policy (5 tokens of 5 on sliding windows, K2 at
stride 1) at ``run_seg -phase test``'s protocol, the two l2f paths timed
in turns (``run_seg``'s ``-compact`` rule on the card); at 1e4 px the
card is held against the JAX package's CPU readings on the same images
(``SEG_REFEREE``), and a planted fault (the fix values inverted) must
cross the gap bound; K2 against its plain version on the 1e5-px first
policy window's 798 848 rows and on a row count that is not a multiple
of 16, and timed there; the brute-force checks of the general eq/ineq
solver (``core.general``); one ``run_seg -phase train`` epoch from
``seg_mha`` through its ``main``, its checkpoint read back into K2.

Then the very-large rung of the reference's instance ladder: its
canonical (1000 items, 100 000 bids) instance, generated by the port's
``generate_cauction(return_coo=True)`` in a worker process while the
earlier phases run (as the 32 xl instances are, in a second worker), as
a struct problem with the Schur G^{-1}
(``make_struct_problem``, ``build_struct_ginv``); the struct products and
the Schur apply against float64 on the host; the plain struct solve
through ``solve_auto`` (rho_change_step 12, cap 6700) and a profile of
its iteration; ``l2f_solve_struct`` with ``ca500_mha``, K2 scoring every
policy window on 100 000 rows, held against the float64 CPU oracle of
``bench_cache/cpu_oracle_1000_100000.json``; K2 against its plain
version on that window's rows; ``mega_l2f --phase labels`` and ``--phase
train`` (one epoch from ``ca500_mha``, the holdout proxy scored by K2) at
a (100, 1000) rung, the best checkpoint read back into K2.

Then the sparse attack (the paper's third workload): 8 synthetic 3 x 32
x 32 images (``attack_images``: smoothed Gaussian random fields,
quantised to 8 bits, with pixels at exactly 0 and 1), the shipped victim
``checkpoints/cifar_victim.npz``, its own labels and the reference's
targets, SLIC masks of 150 segments, the full ``ATTACK_CONFIG`` (k 200,
2000 epsilon and 2000 G iterations); at lambda1 10, the CNN loss's
gradients in epsilon and G and 20 epsilon and 20 G iterations on the
card against the port on the CPU; one ``attack_single`` plain at
``init_lambda1`` and one l2f at lambda1 10 (the shipped ``attack_mha``,
K2 on B * 3072 rows of 50, 10 tokens of 5) against the JAX package's
CPU readings (``ATTACK_REFEREE``), with the policy's scores inverted as a
planted fault; K2 against its plain version on that run's own rows;
the l2f ``attack_with_search`` with the L0 repair (its rounds cut from
6 to 2 to fit the deadline) and its output contract; a profile of an
epsilon and a G iteration.

K1 takes CA's 0/1 E as an exact one-byte copy: resident in shared
memory at CA-500 (the ``int8-resident`` route of the plain and the l2f
solve), streamed at the xl l2f tail's bucket (``int8-stream``); each
K1 check launches the same window again on the f32-stream route (E as
stored) and requires the same bits in every output, and the main path's
routes are required.  Where few instances are live, the tails spread
each over a cluster of C blocks (``fused_lp.split_plan``), which adds
the transpose products' partials in another order: K1 on clusters is
held to the plain version within K1_TOL, each iteration from the
kernel's own state, with a repeat launch that must give the same bits,
done instances returned as they came and a planted fault (the rows of
E of one block's share zeroed), at the compacted (256, 256) bucket
(55, 30 and 1 live: C = 2 with the factor's rows streamed, 4 and 8 with
them resident), from the state the CA-500 tail handed K1 (55, 30 and 15
live) and from the xl tail's (its own live count, with the C its first
launch took, and 15 live: C = 8).

Phases, cheapest first, each under its own deadline and a watchdog that
turns a hang into a traceback and a non-zero exit: device, build (one
nvcc process per source, started together; K1's, K2's, K3's and P1's
registers and spills from ptxas, K3 at the xl block and every P1
instance without spills; K2's encoder and
classifier kernels, each with HMMA instructions in its SASS), K1 (with planted faults that its limits must
catch, and one CA instance with an entry of 0.5 that must take the
f32-stream route) and K2 against their plain PyTorch versions on the
card (K2 also with a repeat launch that must give the same bits, a
planted fault -- its operand made from weights whose last token's block
of wc0 is zeroed -- that must cross K2_TOL, and a count of the rows the
kernel and the plain version put on different sides of the fix margins
0.02 and 0.98), P1-P3 against theirs and the float64
einsum (with a planted fault) and the probe's entry point, the plain
solve, the l2f solve, K1's exit for done instances from the plain
solve's end state, the dense-LP options, the train phase, the dp phase (45 s), the xl instances, K3 (with two planted faults) and K4 against their
plain versions on the first block of 8, the xl solve, a packed-symmetric
window, the xl l2f solve, K2 and K1 against their plain versions on the
operands the xl l2f solve gave them (its first policy window's 131 072
trajectory rows; the tail's start state in its compacted bucket, with a
planted fault), the mega rung, the seg phase, the attack phase, kernel timings (K1 also at that bucket; K2 at 65 536
rows split into its two kernels by the profiler, with its closed-form L2
weight bytes and the card's mma.sync TF32 rate from
``scripts/tc_rate.py``), and last the train phase's time split under the
profiler (a ``core.lp`` window of its dataset solves, one optimizer
step); the whole script under 780 s.
Fails on a build or launch error, a kernel/plain disagreement, a
planted fault that a kernel's limit does not catch, a repeat launch
that differs, a one-byte K1 route that differs from the f32 route in
one bit, an xl tail launch on another C than the one checked, a non-finite value, an infeasible instance, a kernel that its path did not
launch, a K1 launch of the main path on another route than its data
gives, an l2f mean objective gap above +2% against the plain solve, a
resumed training whose loss does not fall, a world-1 NCCL solve that
differs from the main path's, or a gloo rank's from its shard's
one-process solve, in one bit, a rank that fails, hangs or launches
neither K1 nor K2, a 2-rank l2f with other fixes than the main path's or
a gap more than 0.1 point from its shards' one-process solves', a
data-parallel step off the one-process step or a planted dp fault
within its bound, a card step that differs
from the CPU step, a compacting evaluation of the trained policy more
than 10% worse than the plain oracle, an
xl mean objective more than 10% worse than the JAX package's TPU record,
or an xl l2f mean objective more than 10% worse than the xl plain
solve's, a three-limb product more than 1e-6 off float32 or a one-limb
plant within it, a rule-fixing solve without fixes, ``solve_auto`` off
K1 at CA-500, a mega instance of another shape, struct products more
than 1e-5 off float64, an infeasible mega row, or a struct l2f objective
more than 1% above the oracle, seg plain energies off the referee (the
mean by more than 0.5%, an image by more than 2%), a masked seg l2f mean
gap more than 1 point from the referee's or pixels fixed more than 5%
from its, a planted seg fault within that gap bound, a general solve off
its brute-force bound, or a seg training epoch with a non-finite loss or
a checkpoint whose K2 scores differ from the trained module's, a mega
training epoch with a non-finite proxy, the victim's labels on the card
other than the JAX package's, CNN gradients more than 1e-5 (relative)
or 20 epsilon or G iterations more than 1e-3 off the CPU, a CNN term
that moves G by less than ten times that bound, attack results off the referee (success on more than one image, or
mean L0 by more than 0.05 k), a planted attack fault within those
bounds, or a search result that breaks the output contract (G binary, L0
= sum G <= 1.5 k, L-inf <= 1).  Prints one progress line per phase, a JSON ``kernels`` line,
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.

Needs a CUDA device: without one it exits non-zero at once.  It imports
only the port, torch, numpy, scipy and the standard library, and writes
nothing but the kernel build directory ``lpbox_admm_tpu_torch/_build``,
the train phases' checkpoints and caches and the generated instances in
temporary directories it removes; it stops the generation workers before
it exits.
"""

import faulthandler
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "ca500_mha", "checkpoint",
                    "best_checkpoint.npz")
N_ITEMS, N_BIDS, BATCH, SEED = 100, 500, 128, 2207
REPAIR_ROUNDS, SWAP_ROUNDS = 16, 4
# The whole script, build included, at 65% of the 1200 s a caller allows.
# A cold run read 346-453 s before the dp phase (27-33 s) was added; on
# the slowest hosts seen (phases 30-40% slower than those runs'; NVIDIA
# H100 80GB HBM3, 700 W) it reached the attack phase at 491-498 s.
TOTAL_BUDGET_S = 780
# data-sheet figures of the H100 SXM (f32 outside the tensor cores, HBM)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12       # dense, on the tensor cores
PEAK_HBM_BYTES = 3.35e12
K2_TOL = 1e-4                  # absolute, on the sigmoids
# The large rung: the reference's xl instance (800 items x 4000 bids,
# LPboxADMMsolver.cpp:2461-2469), 32 instances made as the JAX package's
# scripts/bench_ladder.py makes them (seed 2207 + n_bids), padded to
# (m, n) = (1664, 4096), solved by that script's shipped xl row
# stream-bf16-c9000-rep.  Its TPU record (bench_cache/ladder.json, quality
# only) is a mean objective of -57 328.3 with 0 infeasible; the f64 CPU
# oracle for instance 0 is -50 731.3 (bench_cache/cpu_oracle_800_4000.json).
XL_ITEMS, XL_BIDS, XL_BATCH, XL_BLOCK = 800, 4000, 32, 8
XL_SEED = 2207 + XL_BIDS
XL_TPU_MEAN_OBJ, XL_ORACLE_OBJ0 = -57328.3, -50731.3
XL_WINDOW, XL_MAX_ITERS = 500, 9000
XL_DROP, XL_REPAIR, XL_SWAP = 64, 16, 4
# One K3 sweep against its plain version: every output to 1e-4 relative
# to max(1, max |ref|) (each of the 12 per-column outputs and F as a
# whole, the 16 sums slot by slot): the same elementwise formulas, with
# f32 sums over m = 1664 rows and n = 4096 columns in another order.
K3_TOL = 1e-4
# K4 against its plain version and the dense product: 1e-5 (sums over
# 1664 terms in another order; the scale is stated in k4_check).
K4_TOL = 1e-5
# P1-P3 against their plain versions and the float64 einsum: 1e-5 of
# max |ref| (f32 sums of n products in another order; P2's three TF32
# passes add about 1e-8).  Held at the probe's shape and at PROBE_XL, the
# xl block shape K3 sweeps.
PROBE_TOL = 1e-5
PROBE_XL = (8, 1664, 4096)
# The xl l2f solve, at the CA-500 operating point: its mean selected
# objective no more than 10% worse than the xl plain solve's (a wiring
# check, as the xl plain limit is: a wrong fix sign or mapping lands far
# beyond it).
XL_L2F_GAP = 0.10
# The train phase: the port's training entry point
# (``lpbox_admm_tpu_torch.scripts.train_ca500_policy``) at full width,
# 8 training and 8 evaluation CA-500 instances, 2 epochs; then the
# shipped checkpoint resumed with its Adam state for TRAIN_STEPS steps on
# the first dataset's episode batch (40 960 rows, 3 micro-chunks of
# 16 384).  One step on the card against the same step on the CPU, in
# float32 and in float64, on the batch's first TRAIN_CHECK_ROWS rows in
# chunks of TRAIN_CHECK_MICRO (the last padded): the loss to 1e-5 of the
# CPU's float32 loss, the gradient within STEP_GRAD_TOL of max |g| of
# both CPU gradients; the same step on the card with TF32 matmuls (a
# planted fault) must be farther than STEP_GRAD_TOL from both.  The
# limit lies between two readings on an H100 80GB HBM3 at 700 W: 3.4e-4
# of max |g| for the sound step, 7.7e-3 for the fault.  The sound
# distance is more than rounding in sums (1e-6 where no ReLU input
# changes sign, in the CPU tests): about 30 of the step's 1.9e8 ReLU
# inputs lie within rounding of 0 and take their side by the summation
# order (38 000 under TF32), and on the trained policy, whose gradient is
# small, a row's flipped term shows (the check logs the flips).  The
# masked ``l2f_solve`` of the resumed policy over
# MASKED_CHECK_ITERS iterations fixes variables, and K2's fixes are the
# module forward's.  The compacting evaluation of the resumed policy:
# mean objective gap against the plain oracle no worse than TRAIN_GAP (a
# wiring bound, as the xl ones are).
TRAIN_ARGS = ["-n_train", "8", "-n_eval", "8", "-epochs", "2",
              "-eval_every", "2"]
TRAIN_STEPS = 5
TRAIN_CHECK_ROWS, TRAIN_CHECK_MICRO = 8192, 3000
STEP_GRAD_TOL = 1e-3
MASKED_CHECK_ITERS = 500
TRAIN_GAP = 0.10

# The segmentation workload (the paper's second): SEG_BATCH synthetic
# images of seg_images' recipe at SEG_GRID (1e4 px, the standard size)
# and at SEG_GRID_XL (99 856 px, the generalisation size), solved plain
# (build_dataset_qp, 50 recorded iterations, polished by SEG_REPAIR
# one-flip and SEG_PAIR domino sweeps) and by the masked and the
# compacting l2f with the shipped seg_mha policy at run_seg -phase test's
# protocol (ws SEG_WS, SEG_MAX_ITER iterations, the same polish).  At 1e4
# px the card is held against the JAX package's CPU run on the same
# images (SEG_REFEREE, made by `JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/torch_port_util.py`, recomputed by tests/test_torch_seg.py): the
# mean plain energy within SEG_MEAN_TOL and each image's within
# SEG_IMAGE_TOL, relative; the masked l2f's mean gap within SEG_GAP_PP
# (absolute, in units of the gap) and its mean pixels fixed within
# SEG_FIX_TOL, relative.  A planted fault -- the policy's fix values
# inverted (scores 1 - s) -- must cross the gap bound.
# The gap is relative to |plain energy|; seed 1's smallest is 571 (seed
# 0's fifth image has +119, where a gap of 99% makes one image's rounding
# noise the 8-image mean's).
SEG_SEED, SEG_SEED_XL = 1, 2
SEG_BATCH = 8
SEG_GRID, SEG_GRID_XL = (100, 100), (316, 316)
SEG_WS, SEG_MAX_ITER, SEG_REPAIR, SEG_PAIR = 10, 30, 8, 4
SEG_REFEREE = {
    "plain_energy": [-2291.0, -1444.0, -571.0, -738.0, -1614.0, -1091.0,
                     -3038.0, -618.0],
    "plain_iters": 650,
    "l2f_gap_mean": 0.06306047737598419,
    "l2f_fixed": [6829, 6688, 6152, 6367, 8309, 6028, 7237, 6480],
    "l2f_fix_errors": [0, 0, 10, 0, 0, 2, 16, 2]}
SEG_MEAN_TOL, SEG_IMAGE_TOL, SEG_GAP_PP, SEG_FIX_TOL = 0.005, 0.02, 0.01, 0.05
SEG_BUDGET_S = 90

# The sparse attack (the paper's third workload): ATTACK_BATCH synthetic
# 3 x 32 x 32 images of attack_images' recipe, the shipped victim
# (checkpoints/cifar_victim.npz), its own predictions as labels and the
# reference's targets, SLIC with ATTACK_SEGMENTS segments and the full
# ATTACK_CONFIG (k 200, maxIter_e 2000, maxIter_g 2000, lambda1 1e-3);
# the l2f G update scores with the shipped attack_mha (node 10 x chunk 5,
# ws 50: K2 on B*3072 rows of 50).
ATTACK_SEED, ATTACK_BATCH, ATTACK_SEGMENTS = 0, 8, 150
# the phase's deadline: its eager iterations are host-bound, and the
# host's speed varies between calls (PERF.md section 5): 57-84 s on the
# hosts of one range, more than 102 s unfinished on one 30-40% slower
ATTACK_BUDGET_S = 180
ATTACK_CKPT = os.path.join(ROOT, "checkpoints", "attack_mha", "checkpoint",
                           "best_checkpoint.npz")
ATTACK_VICTIM = os.path.join(ROOT, "checkpoints", "cifar_victim.npz")
# One attack_single plain at init_lambda1 and one l2f at lambda1 10
# ("l2f_at"), by the JAX package on the CPU on the same images and
# weights (`JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/torch_port_util.py attack`): the victim's labels, the targets,
# and per image success and L0.  The card must give the same labels;
# success per image equal for all but ATTACK_SUCCESS_SLACK images; mean L0
# within ATTACK_L0_TOL * k of the referee's.  The l2f run is at lambda1
# 10 because at init_lambda1 the CNN term is too weak for the result to
# depend on the policy (every entry ends below 0.5 whatever the scores,
# L0 0 in both packages); there the planted fault -- the policy's scores
# inverted (1 - s), as in the seg phase -- must cross the success slack
# or the L0 bound.
ATTACK_REFEREE = {
    "labels": [8, 6, 7, 6, 6, 7, 6, 6], "targets": [6, 4, 5, 4, 4, 5, 4, 4],
    "plain": {"success": [False] * 8,
              "L0": [197, 212, 214, 200, 199, 211, 206, 210]},
    "l2f_at": {"lambda1": 10.0, "success": [True] * 8,
               "L0": [307, 83, 87, 321, 246, 135, 62, 267]}}
ATTACK_SUCCESS_SLACK, ATTACK_L0_TOL = 1, 0.05
# The CNN oracle on the card against the port on the CPU, at lambda1 10
# (where the CNN term moves G; at init_lambda1 it moves it by less than
# the bound): ATTACK_WINDOW epsilon and G iterations held to
# ATTACK_WINDOW_TOL (the bound of every <= 20-iteration comparison of a
# chaotic iteration); the loss gradient at the same inputs to
# ATTACK_GRAD_TOL relative to its largest entry (float32 convolutions
# summed in another order); the CNN term must move G over the window by
# ATTACK_REACH times ATTACK_WINDOW_TOL or more.
ATTACK_WINDOW, ATTACK_WINDOW_LAMBDA = 20, 10.0
ATTACK_WINDOW_TOL, ATTACK_GRAD_TOL, ATTACK_REACH = 1e-3, 1e-5, 10
# the full search's rounds: ATTACK_CONFIG's 6 cut to 2 to fit the
# phase's deadline (an eager round with the repair is 5150 iterations,
# 13-18 s on an H100 80GB HBM3 at 700 W, PERF.md section 5); the second
# round runs the per-image lambda1 update and the merge of rounds.
ATTACK_SEARCH_ROUNDS = 2

# The data-parallel phase (parallel.mesh; after the train phase, on the
# main path's CA-500 batch and the train phase's 40 960-row episode batch,
# written once to an .npz in a temporary directory): a world-1 NCCL group
# in this process (the plain K1 solve of the sharded batch, gathered, bit
# for bit the main path's); DP_RANKS gloo ranks on the one card (NCCL
# takes one rank a card), spawned with a deadline, each on 64 of the 128
# instances: the plain K1 solve (gathered objectives and solutions bit
# for bit those of each shard solved alone in this process, 0
# infeasible; K1's clusters follow a launch's live count, so a shard's
# bits are its own solve's, not the batch's), l2f_solve_compact at the
# main path's operating point (K1, K2; fixes per instance the main
# path's, 0 infeasible, each shard's objectives bit for bit its
# one-process l2f solve's, the mean gap against the ranks' gathered plain
# solve within DP_GAP of the shards' one-process gap; each shard's tail
# bucket logged), and one training step from the shipped checkpoint with its
# Adam state on 20 480 rows a rank (loss within 1e-5 relative and the
# gradient within STEP_GRAD_TOL of max |g| of the one-process step on
# the card; parameters the same bits on both ranks).  Two planted faults:
# BatchNorm on each rank's own rows, which must cross STEP_GRAD_TOL (or,
# where it does not on this data, the second must), and each rank's loss
# over its own rows, which must cross it.  Then dp_scaling_table at one
# rank (a logged row; one card, no scaling claimed).
DP_RANKS, DP_BUDGET_S, DP_GAP = 2, 45, 0.001

T_START = time.perf_counter()


def seg_image(rng, H, W):
    """A synthetic segmentation image: a smoothed Gaussian random field
    (sigma H/12) scaled to [0, 1], plus noise of 0.05, clipped,
    quantised to 8 bits and divided by 263 as the reference's loader
    scales intensities (tests/torch_port_util.py holds the same
    recipe)."""
    import numpy as np
    from scipy.ndimage import gaussian_filter
    f = gaussian_filter(rng.randn(H, W), sigma=H / 12)
    f = (f - f.min()) / (f.max() - f.min())
    f = np.clip(f + 0.05 * rng.randn(H, W), 0.0, 1.0)
    return np.round(255 * f) / 263.0


def seg_images(seed, count, H, W):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [seg_image(rng, H, W) for _ in range(count)]


def attack_images(seed, count, H=32, W=32):
    """Synthetic attack images: per channel a Gaussian random field
    smoothed at sigma H/8, scaled to [0, 1], plus noise of 0.05, clipped,
    quantised to 8 bits and divided by 255 as the reference's loader
    does, so that every image has pixels at exactly 0 and 1 (the tests
    import this function)."""
    import numpy as np
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    out = np.empty((count, 3, H, W), np.float32)
    for i in range(count):
        for c in range(3):
            f = gaussian_filter(rng.randn(H, W), sigma=H / 8)
            f = (f - f.min()) / (f.max() - f.min())
            f = np.clip(f + 0.05 * rng.randn(H, W), 0.0, 1.0)
            out[i, c] = np.round(255 * f) / 255.0
    return out


def log(msg):
    print(msg, flush=True)


class Phase:
    """A phase with its own deadline: the watchdog dumps every thread's
    traceback and exits non-zero once the deadline (or the script's
    total budget) passes, also while the main thread waits on the card;
    the phase ends with a device synchronisation so a kernel fault
    surfaces in the phase that caused it."""

    def __init__(self, name, budget_s):
        self.name, self.budget = name, budget_s

    def __enter__(self):
        left = TOTAL_BUDGET_S - (time.perf_counter() - T_START)
        if left <= 0:
            raise RuntimeError(f"total budget spent before {self.name}")
        faulthandler.dump_traceback_later(min(self.budget, left), exit=True)
        self.t0 = time.perf_counter()
        log(f"[phase] {self.name}: start (deadline {self.budget} s)")
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch
        if exc_type is None and torch.cuda.is_available():
            torch.cuda.synchronize()
        faulthandler.cancel_dump_traceback_later()
        self.seconds = time.perf_counter() - self.t0
        if exc_type is None:
            log(f"[phase] {self.name}: done in {self.seconds:.2f} s")
            if self.seconds > self.budget:
                raise RuntimeError(f"phase {self.name} took "
                                   f"{self.seconds:.1f} s > {self.budget} s")
        return False


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def ptxas_report(text):
    """Registers and spill bytes of K1's, K2's, K3's and P1's instances,
    from the build's ``ptxas -v`` output (empty for a cached build)."""
    import re
    label = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}
    p1_v = {"0": "scalar v", "1": "quad v"}
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for|$)", line.strip())
        if m:
            name = m.group(1)
            k3 = re.search(r"sweep_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
            k1 = re.search(r"lp_window_kernelI(f|13__nv_bfloat16|a)Lb([01])E",
                           name)
            k2 = re.search(r"(policy_(?:encoder|classifier)_kernel)", name)
            p1 = re.search(r"probe_batched_kernelILb([01])E", name)
            cur = (f"K3 sweep_kernel<{label[k3.group(1)]}, RPT={k3.group(2)}>"
                   if k3 else
                   f"K1 lp_window_kernel<{label[k1.group(1)]}, "
                   f"{'resident' if k1.group(2) == '1' else 'stream'}>"
                   if k1 else f"K2 {k2.group(1)}" if k2 else
                   f"P1 probe_batched_kernel<{p1_v[p1.group(1)]}>"
                   if p1 else None)
            if cur:
                out.setdefault(cur, {"registers": None, "stack": None,
                                     "spill_stores": None,
                                     "spill_loads": None})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur]["stack"] = int(m.group(1))
            out[cur]["spill_stores"] = int(m.group(2))
            out[cur]["spill_loads"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def sass_hmma(lib_path):
    """HMMA (tensor-core) instructions in each K2 kernel's SASS, read by
    ``cuobjdump -sass`` from the built library."""
    import re
    from lpbox_admm_tpu_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr}")
    counts, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k2 = re.search(r"(policy_(?:encoder|classifier)_kernel)",
                           m.group(1))
            cur = f"K2 {k2.group(1)}" if k2 else None
            if cur:
                counts[cur] = 0
        elif cur and re.search(r"\bHMMA\.", line):
            counts[cur] += 1
    return counts


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` on the card (CUDA events, after one
    warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def finite(*ts):
    import torch
    return all(bool(torch.isfinite(t.float()).all()) for t in ts)


class FirstCall:
    """Inside a ``with`` block, ``module.name`` is wrapped so that the
    arguments of its first call are kept in ``args`` (positional) and
    ``kwargs``; every call goes through to the function unchanged, so
    the path and its launch counts are as without the wrapper."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.args = self.kwargs = None

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            if self.args is None:
                self.args, self.kwargs = args, kwargs
            return self.real(*args, **kwargs)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, exc_type, exc, tb):
        setattr(self.module, self.name, self.real)
        return False


# K1 against its plain version: every state field is held to K1_TOL in
# the units of x.  O(1) fields (x in [0, 1], its copies, E x, the
# incumbent) absolutely; the duals divided by gamma*rho of the window's
# last iteration, the factor by which a dual step scales an error of x
# (gamma*rho is 40 at the start and 71 600 after 20 000 iterations);
# objectives per instance relative to max(1, |ref|).  The limit sits
# between readings of sound runs and of planted faults that the smoke
# runs each time (PERF.md): after one iteration sound x 6e-5 and duals
# 6e-5, against x 3e-2 for rho of the next schedule step and duals 5e-3
# for gamma 0.1% high.
K1_TOL = 1e-3
K1_ABS = ("x", "y1", "y2", "y3", "ex", "best_sol")
K1_DUALS = ("z1", "z2", "z4")
K1_OBJS = ("cur_obj", "best_bin_obj", "obj_ring")


def k1_errors(s_k, s_p, cfg):
    """Per field: (max abs error, error in the units of x)."""
    from lpbox_admm_tpu_torch.ops.schedule import gamma_at, rho_at
    last = s_p.it - 1
    dual_unit = gamma_at(last, cfg) * rho_at(last, cfg)
    out = {}
    for f in K1_ABS + K1_DUALS + K1_OBJS:
        a, b = getattr(s_k, f).float(), getattr(s_p, f).float()
        d = (a - b).abs()
        ab = d.max().item()
        if f in K1_ABS:
            out[f] = (ab, ab)
        elif f in K1_DUALS:
            out[f] = (ab, ab / dual_unit)
        else:
            out[f] = (ab, (d / b.abs().clamp_min(1.0)).max().item())
    return out


def k1_excess(errs):
    """Fields whose error in the units of x is over K1_TOL."""
    return {f: v for f, (_, v) in errs.items() if not v <= K1_TOL}


def k1_planted(name, s_f, s_p, cfg):
    """A planted fault must cross the limit the sound run meets."""
    over = k1_excess(k1_errors(s_f, s_p, cfg))
    log(f"  K1 planted fault {name}: over {K1_TOL:g} "
        + " ".join(f"{f}={v:.2e}" for f, v in over.items()))
    require(bool(over), f"K1 limit {K1_TOL:g} misses the planted fault "
            f"{name}")


K1_FIELDS = ("x", "z1", "z2", "z4", "y1", "y2", "y3", "ex", "obj_ring",
             "obj_count", "done", "cur_obj", "best_bin_obj", "best_sol",
             "it")


def k1_on(E_op, s, prob, cfg, window, skip_cvg_at=None, record=False,
          nfactor=None, fused_lp=None):
    """``lp_window_fused`` with K1 reading ``E_op`` (its dtype picks the
    route) instead of the operand that E's data gives; not counted in
    the path's launches."""
    a = fused_lp.window_inputs(s, prob, cfg, nfactor)._replace(E=E_op)
    out = fused_lp.window_cuda(a, cfg, s.it, window, skip_cvg_at, record)
    return fused_lp.window_state(s, prob, cfg, window, out, record)


class K1Pair:
    """``lp_window_fused`` on the route its data decides, each launch
    repeated on the f32-stream route (E as stored, the streaming design) and
    required to give the same bits in every output, trajectories
    included: the one-byte routes decode every entry exactly and keep the
    order of the sums.  ``routes`` counts the routes it saw."""

    def __init__(self, fused_lp, want):
        self.fused_lp, self.want, self.routes = fused_lp, want, {}

    def __call__(self, s, prob, cfg, window, **kw):
        fl = self.fused_lp
        before = dict(fl.LAUNCHES)
        k = fl.lp_window_fused(s, prob, cfg, window, **kw)
        launched = [r for r in fl.E_ROUTES if fl.LAUNCHES[r] != before[r]]
        require(launched == [self.want],
                f"K1 launched on {launched}, expected {self.want}")
        route = self.want
        self.routes[route] = self.routes.get(route, 0) + 1
        f = k1_on(prob.E, s, prob, cfg, window, fused_lp=fl, **kw)
        k1_same_bits(k, f, kw.get("record"), f"K1 {route} vs f32-stream")
        return k


def k1_same_bits(k, f, record, what):
    """Every output of two K1 windows equal bit for bit."""
    if record:
        (k, tk), (f, tf) = k, f
        require(torch_equal(tk, tf), f"{what}: trajectory bits")
    diff = [n for n in K1_FIELDS
            if not torch_equal(getattr(k, n), getattr(f, n))]
    require(not diff, f"{what}: bits differ in {diff}")


def torch_equal(a, b):
    import torch
    if not isinstance(a, torch.Tensor):
        return a == b
    return torch.equal(a, b)


def k1_checks(tp, cfg, fused_lp, lp, woodbury):
    """K1 against its plain version on the card at the main path's
    shapes: the 128-instance batch, m side and n side at the tail's
    compacted (256, 256) bucket, and the policy phase's recorded
    100-iteration window held slot by slot.  Every launch runs on the
    int8-resident route (CA's 0/1 E in one byte, resident in shared
    memory) and again on the f32-stream route, which must give the same
    bits.  A CA instance with one entry of E set to 0.5 must take the
    f32-stream route and meet the limit there.  Returns the errors, the
    recorded window's B*n trajectory rows (K2's input shape on the main
    path) and the comparison."""
    res = {}
    fused = K1Pair(fused_lp, "int8-resident")

    def compare(name, s_k, s_p, c=cfg, quiet=False):
        errs = k1_errors(s_k, s_p, c)
        require(finite(*(getattr(s_k, f) for f in errs)),
                f"K1 {name}: finite")
        require(bool((s_k.done == s_p.done).all()), f"K1 {name}: done flags")
        require(bool((s_k.obj_count == s_p.obj_count).all()),
                f"K1 {name}: objective counts")
        over = k1_excess(errs)
        if not quiet or over:
            log(f"  K1 {name}: abs err "
                + " ".join(f"{f}={e[0]:.2e}" for f, e in errs.items())
                + "; in x units "
                + " ".join(f"{f}={errs[f][1]:.2e}" for f in K1_DUALS
                           + K1_OBJS)
                + f"; over {K1_TOL:g}: {over or 'none'}")
        require(not over, f"K1 {name}: {over} over {K1_TOL:g}")
        res[name] = {"max_abs_err_x": max(errs[f][0] for f in K1_ABS),
                     "max_err_x_units": max(e[1] for e in errs.values())}
        return errs

    s0 = lp.init_state(tp, cfg)
    p1 = fused_lp.lp_window_plain(s0, tp, cfg, 1, skip_cvg_at=0)
    compare("mside-1it", fused(s0, tp, cfg, 1, skip_cvg_at=0), p1)
    step = cfg.rho_change_step
    k1_planted("rho of the next schedule step",
               fused(s0.replace(it=step), tp, cfg, 1, skip_cvg_at=step), p1,
               cfg)
    k1_planted("gamma 0.1% high",
               fused(s0, tp, cfg.replace(gamma0=cfg.gamma0 * 1.001), 1,
                     skip_cvg_at=0), p1, cfg)
    p20 = fused_lp.lp_window_plain(s0, tp, cfg, 20, skip_cvg_at=0)
    bcfg = cfg.replace(matvec_dtype="bfloat16")
    for name, c in (("mside-20it", cfg), ("mside-20it-bf16E", bcfg)):
        compare(name, fused(s0, tp, c, 20, skip_cvg_at=0), p20)
    # the bf16 stream of the same E: the same bits again
    import torch
    k1_same_bits(k1_on(tp.E.to(torch.bfloat16), s0, tp, cfg, 20,
                       skip_cvg_at=0, fused_lp=fused_lp),
                 fused_lp.lp_window_fused(s0, tp, cfg, 20, skip_cvg_at=0),
                 False, "K1 bf16-stream vs int8-resident")
    # one CA instance with an entry of E that is not an integer
    half = tp.replace(**{f: getattr(tp, f)[:1].clone() for f in (
        "b", "E", "f", "row_mask", "var_mask")})
    half.E[0, 0, 0] = 0.5
    require(fused_lp.e_route(fused_lp.window_operand(half.E, cfg))
            == "f32-stream",
            "K1: an E entry of 0.5 takes the f32-stream route")
    before = fused_lp.LAUNCHES["f32-stream"]
    sh = lp.init_state(half, cfg)
    compare("f32-stream-half-entry-20it",
            fused_lp.lp_window_fused(sh, half, cfg, 20, skip_cvg_at=0),
            fused_lp.lp_window_plain(sh, half, cfg, 20, skip_cvg_at=0))
    require(fused_lp.LAUNCHES["f32-stream"] == before + 1,
            "K1: the 0.5-entry instance launched on f32-stream")

    # The policy phase's recorded window, held over all its 100 slots.
    # Around iterations 60-80 the iteration amplifies a difference by
    # about 1.4x per step (f32 against f64: 1e-5 at slot 60, 2e-2 at slot
    # 70), so the plain version runs SEG iterations from the kernel's own
    # state at every SEG-th iteration (a shorter launch from the same
    # start) and is compared with those slots of the one long launch.
    SEG = 5
    k, tk = fused(s0, tp, cfg, 100, record=True)
    seg_errs = []
    for t0 in range(0, 100, SEG):
        st = s0 if t0 == 0 else fused(s0, tp, cfg, t0)
        if t0:
            require(bool((tk[..., t0 - 1] == st.x).all()),
                    f"K1 record-100: slot {t0 - 1} is not the kernel's "
                    f"state after {t0} iterations")
        p, tpl = fused_lp.lp_window_plain(st, tp, cfg, SEG, record=True)
        seg_errs.append((tk[..., t0:t0 + SEG] - tpl).abs().max().item())
        require(seg_errs[-1] <= K1_TOL,
                f"K1 record-100 slots {t0}..{t0 + SEG - 1}: "
                f"{seg_errs[-1]:.3e}")
    log(f"  K1 record-100: trajectory abs err per {SEG}-slot segment "
        + " ".join(f"{e:.1e}" for e in seg_errs))
    compare("record-100 end state", k, p)
    res["record-100 trajectory"] = {"max_abs_err_x": max(seg_errs)}
    rows = tk.reshape(-1, 100).contiguous()
    # n side at a compacted (256, 256) shape after one recorded window
    sc, pc, _ = lp.compact(k, tp, cfg, 256, m_new=256)
    nf = woodbury.factorize_nside(pc.E, sc.free, lp._wb_ratio(cfg))
    kn = fused(sc, pc, cfg, 20, nfactor=(nf.hinv, nf.ete))
    pn = fused_lp.lp_window_plain(sc, pc, cfg, 20, nfactor=(nf.hinv, nf.ete))
    compare("nside-256x256-20it", kn, pn)
    # the same state on clusters at the tail's live counts: 55 (C = 2,
    # the factor's rows streamed), 30 (C = 4) and 1 (C = 8; both with
    # the factor's rows resident)
    res["clusters at the compacted bucket"] = {
        "cases": k1_cluster_check(sc, pc, cfg, (nf.hinv, nf.ete), fused_lp,
                                  compare, (55, 30, 1), "nside-256x256",
                                  True)}
    # incumbent stride 8 from the recorded window's end state
    c8 = cfg.replace(incumbent_stride=8)
    k8 = fused(k, tp, c8, 20)
    p8 = fused_lp.lp_window_plain(k, tp, c8, 20)
    compare("stride8-20it", k8, p8, c8)
    log(f"  K1 checks: routes {fused.routes}, each launch equal bit for "
        "bit to its f32-stream launch")
    return res, rows, compare


def zero_counts(fused_lp, fused_policy):
    """Set K1's and K2's launch counts to 0."""
    fused_lp.LAUNCHES.update(dict.fromkeys(fused_lp.E_ROUTES, 0))
    fused_policy.LAUNCHES = 0


def read_counts(fused_lp, fused_policy):
    """K1's (all E routes) and K2's launches since ``zero_counts``."""
    return {"K1": sum(fused_lp.LAUNCHES.values()),
            "K2": fused_policy.LAUNCHES}


def relu_inputs(model):
    """Forward hooks recording the sign of every ReLU input of the
    policy (the feed-forward layers' and the classifier's); returns the
    list they fill and the hooks' handles."""
    signs, hooks = [], []
    lins = [layer.ff[0] for layer in model.layers] \
        + list(model.classifier.layers[:-1])
    for lin in lins:
        hooks.append(lin.register_forward_hook(
            lambda mod, inp, out: signs.append((out > 0).cpu())))
    return signs, hooks


def train_step_on_cpu_check(trainer, x, lab, w):
    """One step from the shipped checkpoint on the card, on the CPU in
    float32 and in float64 (``train_step``'s chunks), and on the card
    with TF32 matmuls (the planted fault), on the same rows.  Returns
    the card's loss error against the CPU's, the gradient distances over
    max |g| of the CPU's float64 gradient (card and TF32 card against
    each CPU gradient, the CPU's float32 against its float64), the worst
    parameter card vs CPU, and the ReLU inputs whose sign differs
    between runs."""
    import torch
    from lpbox_admm_tpu_torch.models.policy import build_policy
    from lpbox_admm_tpu_torch.train import imitation
    out = {}
    for name, dev, dt in (("card", "cuda", torch.float32),
                          ("tf32", "cuda", torch.float32),
                          ("cpu", "cpu", torch.float32),
                          ("cpu64", "cpu", torch.float64)):
        tr = imitation.PolicyTrainer(build_policy("mha"), trainer.pcfg,
                                     trainer.cfg, ws=trainer.ws,
                                     micro_rows=TRAIN_CHECK_MICRO,
                                     device=dev)
        ts = tr.load(CKPT)
        signs, hooks = relu_inputs(ts.model)
        prec = torch.get_float32_matmul_precision()
        if name == "tf32":
            torch.set_float32_matmul_precision("high")
        try:
            if dt == torch.float32:
                ts, loss = tr.train_step(ts, x, lab, w)
            else:   # train_step's chunks, in float64
                m = ts.model.to(dt).train()
                R, k = x.shape[0], TRAIN_CHECK_MICRO
                pad = (-R) % k
                z = lambda t: torch.cat(
                    [t, t.new_zeros((pad,) + t.shape[1:])]).to(dev, dt)
                xp, lp_, wp = z(x), z(lab), z(w)
                loss = 0.0
                for c in range(0, R + pad, k):
                    logits, _ = m(xp[c:c + k])
                    lk = imitation.weighted_bce(
                        logits[:, 0], lp_[c:c + k], wp[c:c + k]) * (k / R)
                    lk.backward()
                    loss += float(lk.detach())
        finally:
            torch.set_float32_matmul_precision(prec)
            for h in hooks:
                h.remove()
        out[name] = (float(loss), {
            n: p.grad.detach().double().cpu()
            for n, p in ts.model.named_parameters()}, signs)
    g64 = out["cpu64"][1]
    G = max(float(g.abs().max()) for g in g64.values())
    err = lambda a, b: {k_: float((out[a][1][k_] - out[b][1][k_]).abs()
                                  .max()) / G for k_ in g64}
    flips = lambda a, b: sum(int((u != v).sum()) for u, v in
                             zip(out[a][2], out[b][2]))
    e_gc = err("card", "cpu")
    worst = max(e_gc, key=e_gc.get)
    lc = out["cpu"][0]
    return dict(loss_rel_err=abs(out["card"][0] - lc) / abs(lc),
                card_vs_cpu=e_gc[worst], worst_param=worst,
                card_vs_cpu64=max(err("card", "cpu64").values()),
                cpu_vs_cpu64=max(err("cpu", "cpu64").values()),
                tf32_vs_cpu=max(err("tf32", "cpu").values()),
                tf32_vs_cpu64=max(err("tf32", "cpu64").values()),
                relu_flips={"card_cpu": flips("card", "cpu"),
                            "card_cpu64": flips("card", "cpu64"),
                            "cpu_cpu64": flips("cpu", "cpu64"),
                            "tf32_cpu64": flips("tf32", "cpu64")},
                relu_inputs=sum(v.numel() for v in out["cpu"][2]))


def masked_fix_check(l2f, model, prob, tr):
    """The masked ``l2f_solve`` of ``model`` on the card over
    MASKED_CHECK_ITERS iterations, scored by K2 as the path scores, and
    again with the module's forward as the scorer.  Returns the number
    of fixed variables and whether both runs fixed the same variables to
    the same values."""
    st_k = l2f.l2f_solve(prob, model, tr.cfg, tr.pcfg, ws=tr.ws,
                         max_iter=MASKED_CHECK_ITERS)
    scorer = l2f._scorer
    l2f._scorer = lambda model_, pcfg, device, row_chunk: (
        lambda rows: l2f.policy_scores(model_, rows, pcfg, row_chunk))
    try:
        st_p = l2f.l2f_solve(prob, model, tr.cfg, tr.pcfg, ws=tr.ws,
                             max_iter=MASKED_CHECK_ITERS)
    finally:
        l2f._scorer = scorer
    same = torch_equal(st_k.free, st_p.free) \
        and torch_equal(st_k.fixed_val, st_p.fixed_val)
    return int((~st_k.free & prob.var_mask).sum()), same


def train_split(prob, cfg, tr, ts, x, lab, w, W=100, WP=20):
    """Where the train phase's time goes: the ``core.lp`` window that
    ``build_dataset`` and the masked evaluation run (W iterations timed,
    WP under the profiler: the card's busy time and kernels per
    iteration, idle share = 1 - busy / wall), and one optimizer step at
    the episode batch's rows under the profiler (busy time, idle share,
    the three kernels with the most device time).  Launches neither K1
    nor K2."""
    import torch
    from lpbox_admm_tpu_torch.core import lp
    P = torch.profiler
    s0 = lp.init_state(prob, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp.solve_window(s0, prob, cfg, W, record=True, skip_cvg_at=0)
    torch.cuda.synchronize()
    wall_it = (time.perf_counter() - t0) * 1e3 / W
    with P.profile(activities=[P.ProfilerActivity.CUDA]) as prof:
        lp.solve_window(s0, prob, cfg, WP, record=True, skip_cvg_at=0)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    busy_it = sum(e.self_device_time_total for e in ev) / 1e3 / WP
    kern_it = sum(e.count for e in ev if e.self_device_time_total > 0) / WP
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with P.profile(activities=[P.ProfilerActivity.CUDA]) as prof:
        ts, loss = tr.train_step(ts, x, lab, w)
        float(loss)
    wall_step = (time.perf_counter() - t0) * 1e3
    ev = sorted((e for e in prof.key_averages()
                 if e.self_device_time_total > 0),
                key=lambda e: -e.self_device_time_total)
    busy_step = sum(e.self_device_time_total for e in ev) / 1e3
    return ts, {
        "lp_window": {"shape": list(prob.E.shape), "wall_ms_per_it": wall_it,
                      "device_busy_ms_per_it": busy_it,
                      "device_kernels_per_it": kern_it,
                      "device_idle_share": 1.0 - busy_it / wall_it},
        "train_step": {"rows": x.shape[0], "wall_ms_profiled": wall_step,
                       "device_busy_ms": busy_step,
                       "device_kernels": sum(e.count for e in ev),
                       "device_idle_share": 1.0 - busy_step / wall_step,
                       "top_kernels_ms": [
                           [e.key[:60], e.self_device_time_total / 1e3]
                           for e in ev[:3]]}}


def train_phase(fused_lp, fused_policy, l2f):
    """The train phase (see TRAIN_ARGS).  Returns the summary, this
    path's K1 and K2 launches (the entry point's and the compacting
    evaluation's; the checks' launches are not counted), a function
    that profiles the phase's time (``train_split``), to be run last,
    and the episode batch (x, labels, weights) of its steps."""
    import tempfile
    import numpy as np
    import torch
    from lpbox_admm_tpu_torch.scripts import train_ca500_policy
    from lpbox_admm_tpu_torch.train import imitation
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    res = {}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out:
        zero_counts(fused_lp, fused_policy)
        t0 = time.perf_counter()
        run = train_ca500_policy.main(TRAIN_ARGS + ["-out", out],
                                      log=lambda s_: log("    " + s_))
        torch.cuda.synchronize()
        res["main_s"] = time.perf_counter() - t0
        res["launches_main"] = read_counts(fused_lp, fused_policy)
        tr, m = run.trainer, run.metrics
        res["dataset_walls_s"] = [ds.oracle_wall_s for ds in run.datasets] \
            + [run.eval_ds.oracle_wall_s]
        res["oracle_iters"] = [ds.oracle_iters for ds in run.datasets] \
            + [run.eval_ds.oracle_iters]
        res["masked_eval"] = {k: float(np.mean(m[k])) for k in (
            "wall_time_s", "mean_obj_gap", "iterations", "n_fixed",
            "fix_errors", "infeasible")}
        log(f"  entry point: {res['main_s']:.2f} s, build_dataset walls "
            f"{[round(v, 3) for v in res['dataset_walls_s']]} s (oracle "
            f"iterations {res['oracle_iters']}), masked evaluation "
            f"{res['masked_eval']}, launches {res['launches_main']}")
        require(res["launches_main"]["K2"] > 0,
                f"the masked evaluation scored with K2: "
                f"{res['launches_main']}")
        require(np.isfinite(m["obj"]).all(), "masked evaluation: finite")

        # the shipped checkpoint resumed, Adam state included
        ts = tr.load(CKPT)
        require(ts.step == 320 and imitation.adam_count(ts.optimizer) == 320,
                "resumed the shipped checkpoint at step 320")
        x, lab, w = imitation.episode_batch(run.datasets[0], tr.pcfg, tr.ws)
        require(x.shape[0] == 40960, f"episode batch rows {x.shape[0]}")
        losses, step_ms = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ts, loss = tr.train_step(ts, x, lab, w)
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t1) * 1e3)
        res.update(resume_losses=losses, step_ms=step_ms)
        log(f"  {TRAIN_STEPS} steps of {x.shape[0]} rows "
            f"({-(-x.shape[0] // tr.micro_rows)} micro-chunks): losses "
            f"{losses}, ms per step {[round(v, 2) for v in step_ms]}")
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"resumed training lowers the loss: {losses}")

        # the compacting evaluation of the resumed policy, counts from 0
        zero_counts(fused_lp, fused_policy)
        mc = tr.evaluate(ts, run.eval_prob, run.eval_ds, compact=True)
        res["launches_compact"] = read_counts(fused_lp, fused_policy)
        res["compact_eval"] = {k: float(np.mean(mc[k])) for k in (
            "wall_time_s", "mean_obj_gap", "iterations", "n_fixed",
            "fix_errors", "infeasible")}
        log(f"  compacting evaluation: {res['compact_eval']}, launches "
            f"{res['launches_compact']}")
        require(res["launches_compact"]["K1"] > 0
                and res["launches_compact"]["K2"] > 0,
                f"compacting evaluation launched K1 and K2: "
                f"{res['launches_compact']}")
        require(np.isfinite(mc["obj"]).all(), "compact evaluation: finite")
        require(mc["mean_obj_gap"] <= TRAIN_GAP,
                f"compact evaluation mean gap {mc['mean_obj_gap']:+.4f} "
                f"<= {TRAIN_GAP}")
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

        # checks: the masked solve's fixes through K2 ...
        t1 = time.perf_counter()
        nfix, same = masked_fix_check(l2f, tr.variables(ts), run.eval_prob,
                                      tr)
        res["masked_check"] = {"n_fixed": nfix, "same_as_plain": same}
        log(f"  masked l2f_solve of the resumed policy, "
            f"{MASKED_CHECK_ITERS} iterations, K2 against the module's "
            f"forward as scorer ({time.perf_counter() - t1:.1f} s): "
            f"{nfix} fixed, same fixes {same}")
        require(nfix > 0 and same, "masked l2f_solve: K2 fixes variables, "
                "the same as the module's forward")
        # ... the card's step against the CPU's ...
        n = TRAIN_CHECK_ROWS
        t1 = time.perf_counter()
        chk = train_step_on_cpu_check(tr, x[:n].cpu(), lab[:n].cpu(),
                                      w[:n].cpu())
        res["step_check"] = chk
        log(f"  one step on the card against the CPU ({n} rows, chunks of "
            f"{TRAIN_CHECK_MICRO}; {time.perf_counter() - t1:.1f} s): loss "
            f"rel. error {chk['loss_rel_err']:.3e}; gradients, over max |g| "
            f"of the CPU's float64 gradient: card vs CPU float32 "
            f"{chk['card_vs_cpu']:.3e} (worst {chk['worst_param']}), vs "
            f"float64 {chk['card_vs_cpu64']:.3e}; CPU float32 vs float64 "
            f"{chk['cpu_vs_cpu64']:.3e}; planted TF32 fault vs CPU float32 "
            f"{chk['tf32_vs_cpu']:.3e}, vs float64 "
            f"{chk['tf32_vs_cpu64']:.3e}; ReLU inputs of other sign "
            f"{chk['relu_flips']} of {chk['relu_inputs']}")
        require(chk["loss_rel_err"] <= 1e-5, "card loss matches the CPU's")
        require(max(chk["card_vs_cpu"], chk["card_vs_cpu64"])
                <= STEP_GRAD_TOL,
                f"card gradient within {STEP_GRAD_TOL} of max |g| of the "
                f"CPU's float32 and float64 gradients")
        require(min(chk["tf32_vs_cpu"], chk["tf32_vs_cpu64"])
                > STEP_GRAD_TOL, "the planted TF32 fault fails the check")
        # ... and the checkpoint in the JAX format, read back into K2
        tr.save(ts, 99)
        path = os.path.join(tr.save_dir, "checkpoint", "checkpoint_99.npz")
        with np.load(path, allow_pickle=False) as z:
            require(len(z.files) == 114 and z["opt/0000"].dtype == np.int32
                    and int(z["step"]) == 320 + TRAIN_STEPS,
                    "checkpoint in the JAX package's format")
        packed = fused_policy.pack_policy_weights(load_policy(path))
        rows = run.eval_ds.traj[:, :, :tr.ws].reshape(-1, tr.ws)
        rows = rows.contiguous()
        k2 = fused_policy.policy_scores_cuda(
            packed, rows, fused_policy.stride_of(tr.pcfg))
        plain = l2f.policy_scores(ts.model, rows, tr.pcfg)
        res["reload_k2_err"] = float((k2 - plain).abs().max())
        log(f"  saved and reloaded: K2 against the trained module's "
            f"forward on {rows.shape[0]} rows: {res['reload_k2_err']:.2e}")
        require(res["reload_k2_err"] <= K2_TOL,
                f"reloaded policy within K2_TOL {K2_TOL}")
    launches = {k: res["launches_main"][k] + res["launches_compact"][k]
                for k in ("K1", "K2")}
    # the profile of the phase's time runs last in the script: a profiler
    # run over a backward pass (autograd's own thread) left later
    # profiler runs without kernel names and the host's dispatch slower
    # in earlier runs of this script
    split = lambda: train_split(run.eval_prob, tr.cfg, tr, ts, x, lab, w)[1]
    return res, launches, split, (x, lab, w)


def smoke_configs():
    """The main path's solver and policy configurations."""
    from lpbox_admm_tpu_torch.config import LP_CONFIG, PolicyConfig
    return (LP_CONFIG.replace(linsolve="woodbury", incumbent_stride=8),
            PolicyConfig(net="mha", fix_confidence=0.98, fix_windows=2,
                         damage_gate=0.25))


DP_FIELDS = ("b", "E", "f", "row_mask", "var_mask")


def dp_rank(mesh, npz):
    """One of the dp phase's gloo ranks (spawned): the plain and the l2f
    solve of its shard, then the step, sound and with each planted fault
    (``parallel.dryrun.dp_step``).  Rank 0 returns the gathered results
    and the gradients; every rank its launches, walls, tail bucket, own
    l2f objectives and parameters after each step."""
    import importlib
    import threading
    import numpy as np
    import torch
    from lpbox_admm_tpu_torch.config import PolicyConfig
    from lpbox_admm_tpu_torch.core import lp
    from lpbox_admm_tpu_torch.core.problem import LpProblem
    from lpbox_admm_tpu_torch.models import fused_policy
    from lpbox_admm_tpu_torch.ops import fused_lp
    from lpbox_admm_tpu_torch.parallel import dryrun
    from lpbox_admm_tpu_torch.parallel.mesh import gather_batch, shard_batch
    from lpbox_admm_tpu_torch.train import l2f
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    from lpbox_admm_tpu_torch.utils.profiling import sync
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torch.optim imports torch._dynamo at its first step: in a fresh
    # rank that step took 10.8-12.0 s, 1.2 s with the import made in the
    # background while the solves below wait on the card
    warm = threading.Thread(target=importlib.import_module,
                            args=("torch._dynamo",), daemon=True)
    warm.start()
    say = lambda msg: log(f"    [rank {mesh.rank}, "
                          f"{time.perf_counter() - T_START:.1f} s] {msg}")
    say(f"joined the group on {mesh.device} ({mesh.backend})")
    cfg, pcfg = smoke_configs()
    with np.load(npz, allow_pickle=False) as z:
        prob = LpProblem(**{f: torch.from_numpy(z[f]) for f in DP_FIELDS})
        rows = tuple(torch.from_numpy(z[k]) for k in ("x", "lab", "w"))
    shard = shard_batch(prob, mesh)
    out = {"device": str(mesh.device), "backend": mesh.backend}
    zero_counts(fused_lp, fused_policy)
    t0 = time.perf_counter()
    st = fused_lp.solve_fused(shard, cfg, max_iters=cfg.max_iters,
                              window=100)
    _, obj, inf = lp.select_solution(
        shard, lp.solution(st), lp.solution_best(st),
        repair_rounds=REPAIR_ROUNDS, swap_rounds=SWAP_ROUNDS)
    sync(obj)
    out["plain_s"] = time.perf_counter() - t0
    out["plain_it"] = st.it
    out["launches_plain"] = read_counts(fused_lp, fused_policy)
    say(f"plain solve {out['plain_s']:.2f} s")
    plain = gather_batch({"obj_k1": lp.objective(st),
                          "sol_k1": lp.solution(st), "obj": obj,
                          "inf": inf}, mesh)
    model = load_policy(CKPT, device=mesh.device)
    zero_counts(fused_lp, fused_policy)
    t0 = time.perf_counter()
    tm = {}
    _, lo = l2f.l2f_solve_compact(
        shard, model, cfg, pcfg, ws=100, policy_windows=3,
        rho_boost_iters=5000, max_iter=10000, repair_rounds=REPAIR_ROUNDS,
        swap_rounds=SWAP_ROUNDS, timings=tm)
    sync(lo["obj"])
    out["l2f_s"] = time.perf_counter() - t0
    out["launches_l2f"] = read_counts(fused_lp, fused_policy)
    say(f"l2f solve {out['l2f_s']:.2f} s")
    out["buckets"] = tm["buckets"]
    out["routes"] = (tm["policy_route"], tm["tail_route"])
    out["l2f_obj"] = lo["obj"].cpu()
    l2f_g = gather_batch({"obj": lo["obj"], "inf": lo["infeasible"],
                          "n_fixed": lo["n_fixed"]}, mesh)
    warm.join()
    steps = {}
    for plant in (None, "bn", "loss"):
        t0 = time.perf_counter()
        r = dryrun.dp_step(mesh, CKPT, rows, "mha", PolicyConfig(net="mha"),
                           cfg, 100, plant=plant)
        r["s"] = time.perf_counter() - t0
        say(f"step (plant {plant}) {r['s']:.2f} s")
        if mesh.rank:
            r.pop("grad")
        steps[str(plant)] = r
    out["steps"] = steps
    if mesh.rank == 0:
        out["plain"] = {k: v.cpu() for k, v in plain.items()}
        out["l2f"] = {k: v.cpu() for k, v in l2f_g.items()}
    return out


def dp_phase(prob, st, out, tm, gap, rows, budget):
    """The dp phase (see DP_RANKS).  The ranks start first and run while
    this process runs the world-1 NCCL solve and the one-process step
    (a rank's start, with its first step's warm-up, is most of the
    phase).  Returns the summary and the K1 and K2 launches of each
    rank's plain and l2f solves."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    import torch.distributed as dist
    from lpbox_admm_tpu_torch.core import lp
    from lpbox_admm_tpu_torch.models import fused_policy
    from lpbox_admm_tpu_torch.models.policy import build_policy
    from lpbox_admm_tpu_torch.config import PolicyConfig
    from lpbox_admm_tpu_torch.ops import fused_lp
    from lpbox_admm_tpu_torch.parallel import mesh as pm
    from lpbox_admm_tpu_torch.train import imitation, l2f
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    t_start = time.perf_counter()
    cfg, pcfg = smoke_configs()
    res = {}
    x, lab, w = rows
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "dp_batch.npz")
        np.savez(npz, x=x.cpu().numpy(), lab=lab.cpu().numpy(),
                 w=w.cpu().numpy(), **{f: getattr(prob, f).cpu().numpy()
                                       for f in DP_FIELDS})
        # two ranks on the one card, gloo, in the background; leaving the
        # pool waits for them (each bounded by the deadline)
        with ThreadPoolExecutor(1) as pool:
            t_ranks = time.perf_counter()
            ranks_f = pool.submit(
                pm.launch, dp_rank, DP_RANKS, npz,
                devices=["cuda:0"] * DP_RANKS, backend="gloo",
                collective_timeout_s=30,
                timeout_s=budget - (time.perf_counter() - t_start) - 6)
            # world 1 on NCCL, in this process
            t0 = time.perf_counter()
            mesh = pm.init_distributed(
                num_processes=1, process_id=0, backend="nccl",
                device="cuda:0", init_method=f"file://{tmp}/nccl_store",
                timeout_s=30)
            try:
                zero_counts(fused_lp, fused_policy)
                s1 = fused_lp.solve_fused(pm.shard_batch(prob, mesh), cfg,
                                          max_iters=cfg.max_iters,
                                          window=100)
                g1 = pm.gather_batch({"obj": lp.objective(s1),
                                      "sol": lp.solution(s1)}, mesh)
                k1_w1 = read_counts(fused_lp, fused_policy)["K1"]
            finally:
                dist.destroy_process_group()
            torch.cuda.synchronize()
            res["nccl_world1_s"] = time.perf_counter() - t0
            # the one-process step on the card, the reference of the ranks'
            t0 = time.perf_counter()
            tr = imitation.PolicyTrainer(build_policy("mha"),
                                         PolicyConfig(net="mha"), cfg,
                                         ws=100, device="cuda")
            ts, loss1 = tr.train_step(tr.load(CKPT), x, lab, w)
            loss1 = float(loss1)
            grad1 = torch.cat([p.grad.reshape(-1).cpu()
                               for p in ts.model.parameters()])
            res["step_one_process_s"] = time.perf_counter() - t0
            # each shard solved alone in this process, while the ranks
            # run: their reference (a shard's live counts, and so K1's
            # clusters, are not the batch's)
            t0 = time.perf_counter()
            model = load_policy(CKPT, device="cuda")
            k = prob.batch // DP_RANKS
            refs = []
            for rk in range(DP_RANKS):
                sh = type(prob)(**{f: getattr(prob, f)[rk * k:(rk + 1) * k]
                                   for f in DP_FIELDS})
                s_sh = fused_lp.solve_fused(sh, cfg, max_iters=cfg.max_iters,
                                            window=100)
                _, obj_sh, _ = lp.select_solution(
                    sh, lp.solution(s_sh), lp.solution_best(s_sh),
                    repair_rounds=REPAIR_ROUNDS, swap_rounds=SWAP_ROUNDS)
                _, lo_sh = l2f.l2f_solve_compact(
                    sh, model, cfg, pcfg, ws=100, policy_windows=3,
                    rho_boost_iters=5000, max_iter=10000,
                    repair_rounds=REPAIR_ROUNDS, swap_rounds=SWAP_ROUNDS)
                refs.append({"obj_k1": lp.objective(s_sh).cpu(),
                             "sol_k1": lp.solution(s_sh).cpu(),
                             "obj": obj_sh.cpu(),
                             "l2f_obj": lo_sh["obj"].cpu()})
            ref = {f: torch.cat([r[f] for r in refs]) for f in refs[0]}
            res["shard_refs_s"] = time.perf_counter() - t0
            ranks = ranks_f.result()
            res["ranks_s"] = time.perf_counter() - t_ranks
    same1 = torch_equal(g1["obj"], lp.objective(st)) and \
        torch_equal(g1["sol"], lp.solution(st))
    log(f"  world 1 on NCCL: sharded K1 solve and gather "
        f"{res['nccl_world1_s']:.2f} s, K1 launches {k1_w1}, "
        f"objectives and solutions bit for bit the main path's: {same1}")
    require(same1 and k1_w1 > 0, "world-1 NCCL solve = the main path's")
    r0 = ranks[0]
    B = prob.batch
    k = B // DP_RANKS
    pl, l2 = r0["plain"], r0["l2f"]
    same_plain = torch_equal(pl["obj_k1"], ref["obj_k1"]) and \
        torch_equal(pl["sol_k1"], ref["sol_k1"])
    # not held (K1's clusters follow a launch's live count, so a shard's
    # bits and gap are its own): the gathered results against the main
    # path's whole-batch solves, logged so that a drift shows
    main_plain_bits = torch_equal(pl["obj_k1"], lp.objective(st).cpu()) \
        and torch_equal(pl["sol_k1"], lp.solution(st).cpu())
    n_inf_plain = int((pl["inf"] > 0).sum())
    gap_dp = ((l2["obj"] - pl["obj"]) / pl["obj"].abs()).mean().item()
    gap_ref = ((ref["l2f_obj"] - ref["obj"]) / ref["obj"].abs()).mean() \
        .item()
    gap_main = gap.mean().item()
    same_fixes = torch_equal(l2["n_fixed"], out["n_fixed"].cpu())
    n_inf_l2f = int((l2["inf"] > 0).sum())
    buckets = [r["buckets"] for r in ranks]
    bits = {rk: torch_equal(r["l2f_obj"], refs[rk]["l2f_obj"])
            for rk, r in enumerate(ranks)}
    launches = [{"plain": r["launches_plain"], "l2f": r["launches_l2f"]}
                for r in ranks]
    G = float(grad1.abs().max())
    st0 = r0["steps"]
    dist_of = lambda name: float((st0[name]["grad"] - grad1).abs().max()) / G
    d_sound, d_bn, d_loss = dist_of("None"), dist_of("bn"), dist_of("loss")
    loss_err = abs(st0["None"]["loss"] - loss1) / abs(loss1)
    same_params = all(torch_equal(ranks[0]["steps"][n]["params"],
                                  ranks[1]["steps"][n]["params"])
                      for n in ("None", "bn", "loss"))
    res.update(
        ranks=[{k_: r[k_] for k_ in ("device", "backend", "plain_s",
                                     "plain_it", "l2f_s", "buckets",
                                     "routes")} for r in ranks],
        launches=launches, plain_bits=same_plain,
        plain_infeasible=n_inf_plain, l2f_gap=gap_dp, l2f_gap_ref=gap_ref,
        plain_bits_main_not_held=main_plain_bits,
        l2f_gap_minus_main_not_held=gap_dp - gap_main,
        l2f_gap_main=gap_main, l2f_same_fixes=same_fixes,
        l2f_infeasible=n_inf_l2f, l2f_bits_of_shard_solves=bits,
        main_bucket=tm["buckets"], step_loss_rel_err=loss_err,
        step_grad=d_sound, plant_bn=d_bn, plant_loss=d_loss,
        same_params=same_params,
        step_s={n: [r["steps"][n]["s"] for r in ranks]
                for n in ("None", "bn", "loss")})
    log(f"  {DP_RANKS} gloo ranks on one card ({res['ranks_s']:.2f} s "
        f"with the start): " + "; ".join(
            f"rank {i} on {r['device']}: plain {r['plain_s']:.2f} s "
            f"({r['plain_it']} it), l2f {r['l2f_s']:.2f} s, tail bucket "
            f"{tuple(r['buckets'])}, routes {r['routes']}, launches "
            f"{launches[i]}" for i, r in enumerate(ranks)))
    log(f"  gathered plain: bit for bit the shards' one-process solves' "
        f"{same_plain}, infeasible {n_inf_plain}; l2f: gap {gap_dp:+.4%} "
        f"(the shards' one-process solves {gap_ref:+.4%}, main path "
        f"{gap_main:+.4%}), fixes per instance the main path's "
        f"{same_fixes}, infeasible {n_inf_l2f}; the main path's bucket "
        f"{tuple(tm['buckets'])}, the shards' {buckets}, objectives bit "
        f"for bit the shards' one-process l2f solves': {bits}")
    log(f"  not held: gathered plain bit for bit the main path's "
        f"{main_plain_bits}; 2-rank l2f gap minus the main path's "
        f"{gap_dp - gap_main:+.4%} (held: minus the shards' one-process "
        f"{gap_dp - gap_ref:+.4%}, within {DP_GAP:.1%})")
    log(f"  DP step, 20 480 rows a rank, against the one-process step on "
        f"the card: loss rel. error {loss_err:.3e}, gradient "
        f"{d_sound:.3e} of max |g|; planted per-rank BatchNorm "
        f"{d_bn:.3e}, planted per-rank loss normalisation {d_loss:.3e} "
        f"(bound {STEP_GRAD_TOL}); parameters equal on both ranks "
        f"{same_params}; step seconds {res['step_s']}")
    require(same_plain and n_inf_plain == 0,
            "2-rank plain solve: the shards' one-process bits, 0 infeasible")
    require(all(l_["plain"]["K1"] > 0 and l_["l2f"]["K1"] > 0
                and l_["l2f"]["K2"] > 0 for l_ in launches),
            f"every rank launched K1 and K2: {launches}")
    require(same_fixes and n_inf_l2f == 0,
            "2-rank l2f: the main path's fixes, 0 infeasible")
    require(abs(gap_dp - gap_ref) <= DP_GAP,
            f"2-rank l2f gap within {DP_GAP:.1%} of the shards' one-process "
            f"solves'")
    require(all(bits.values()), f"l2f shards' one-process bits: {bits}")
    require(loss_err <= 1e-5 and d_sound <= STEP_GRAD_TOL and same_params,
            "DP step = the one-process step on the card")
    require(d_loss > STEP_GRAD_TOL and (d_bn > STEP_GRAD_TOL
                                        or d_loss > STEP_GRAD_TOL),
            "the planted faults cross STEP_GRAD_TOL")
    t0 = time.perf_counter()
    res["dp_scaling"] = pm.dp_scaling_table(prob, cfg, iters=200,
                                            device_counts=(1,), reps=2)
    log(f"  dp_scaling_table at one rank ({time.perf_counter() - t0:.2f} "
        f"s): {res['dp_scaling']}")
    return res, launches


def k1_done_check(st, prob, cfg, fused_lp, compare):
    """K1's exit for done instances against the plain version: from the
    plain solve's end state, where most instances are done, an unrecorded
    and a recorded 20-iteration window; every output is compared, and a
    done instance's outputs must be exactly its frozen state (y1 = y2 =
    x, y3 = f_eff, every trajectory slot = x)."""
    d = st.done
    require(bool(d.any()), "done check: some instance is done")
    fused = K1Pair(fused_lp, "int8-resident")
    for record in (False, True):
        name = f"done-freezing{'-record' if record else ''}-20it"
        k = fused(st, prob, cfg, 20, record=record)
        p = fused_lp.lp_window_plain(st, prob, cfg, 20, record=record)
        if record:
            (k, tk), (p, tpl) = k, p
            require(bool((tk[d] == st.x[d][..., None]).all()),
                    f"{name}: done instances' trajectory is frozen x")
            e = (tk - tpl).abs().max().item()
            log(f"  K1 {name}: trajectory abs err {e:.2e}")
            require(e <= K1_TOL, f"{name}: trajectory {e:.3e}")
        compare(name, k, p)
        frozen = {"x": st.x, "y1": st.x, "y2": st.x, "y3": st.f_eff,
                  "z1": st.z1, "z2": st.z2, "z4": st.z4,
                  "best_sol": st.best_sol, "obj_ring": st.obj_ring,
                  "obj_count": st.obj_count, "cur_obj": st.cur_obj,
                  "best_bin_obj": st.best_bin_obj}
        moved = [f for f, v in frozen.items()
                 if not bool((getattr(k, f)[d] == v[d]).all())]
        require(not moved, f"{name}: done instances changed {moved}")
    return int(d.sum())


def k2_check(fused_policy, packed, op, rows, pcfg, l2f, model=None):
    """K2 (on the kernel operand ``op``) against its plain version (and
    the torch module, given one) on ``rows`` trajectory rows, a repeat
    launch that must give the same bits, and a planted fault that must
    cross K2_TOL: the operand made from weights whose last token's block
    of wc0 is zeroed, held against the plain version of the sound
    weights.  Logs how many rows the kernel and the plain version put on
    different sides of the fix margins 0.02 and 0.98 (not required).
    Returns the largest absolute error."""
    stride = fused_policy.stride_of(pcfg)
    sk = fused_policy.policy_scores_fused(packed, rows, pcfg, op)
    sp = fused_policy.policy_scores_plain(packed, rows, stride)
    k2_err = (sk - sp).abs().max().item()
    again = fused_policy.policy_scores_cuda(packed, rows, stride, op)
    T, E = packed.peb.shape
    wc0 = packed.wc0.clone()
    wc0[(T - 1) * E:].zero_()
    bad = fused_policy.policy_operand(packed._replace(wc0=wc0))
    fault = (fused_policy.policy_scores_cuda(packed, rows, stride, bad)
             - sp).abs().max().item()
    sides = {m: int(((sk > m) != (sp > m)).sum().item())
             for m in (0.02, 0.98)}
    vs_module = ""
    if model is not None:
        sm = l2f.policy_scores(model, rows, pcfg)
        vs_module = f", vs module {(sk - sm).abs().max().item():.3e}"
    log(f"  K2 on {rows.shape[0]} trajectory rows: max abs err vs plain "
        f"{k2_err:.3e} (tol {K2_TOL:g}){vs_module}; repeat launch same "
        f"bits {torch_equal(sk, again)}; planted fault (last token's wc0 "
        f"block zeroed) {fault:.3e}; rows on different sides of 0.02 / "
        f"0.98 (kernel vs plain): {sides[0.02]} / {sides[0.98]}")
    require(finite(sk) and k2_err <= K2_TOL,
            f"K2 on {rows.shape[0]} rows: error {k2_err:.3e}")
    require(torch_equal(sk, again), "K2: a repeat launch gives the same bits")
    require(fault > K2_TOL, f"K2 planted fault crosses {K2_TOL:g}: "
            f"{fault:.3e}")
    return k2_err


def xl_tail_k1_check(st, prob, cfg, nfactor, fused_lp, compare, W=20):
    """K1 against its plain version at the xl l2f tail's compacted bucket,
    from the state the path handed K1 (after compaction and the rho
    fast-forward): one iteration, the planted fault of rho of the next
    schedule step that the limit must catch, and a recorded W-iteration
    launch held iteration by iteration.  From this state the iteration
    amplifies a difference by two orders of magnitude in 20 steps (the
    plain version run on from the kernel's and from its own state after
    one iteration, logged with the straight W-iteration comparison), so
    the plain version runs each iteration from the kernel's own state (a
    shorter launch from the same start); its trajectory slot and every
    state field are compared, over iterations that include incumbent
    ones.  These launches run one block an instance; then K1 on clusters
    from the same state (``k1_cluster_check``) at the path's live count,
    with the C the path's first tail launch took, and at 15 live (C =
    8).  Returns the cluster cases."""
    B, m, n = prob.E.shape
    side = "nside" if nfactor is not None else "mside"
    pair = K1Pair(fused_lp, "int8-stream")
    fused = lambda s, w, **kw: pair(s, prob, cfg, w, nfactor=nfactor, **kw)
    plain = lambda s, w, **kw: fused_lp.lp_window_plain(
        s, prob, cfg, w, nfactor=nfactor, **kw)
    log(f"  K1 at the xl tail bucket: ({B}, {m}, {n}) {side}, it {st.it}, "
        f"{int(st.done.sum())} done, route "
        f"{fused_lp.e_route(fused_lp.window_operand(prob.E, cfg))}")
    p1 = plain(st, 1)
    compare(f"xl-tail-{side}-1it", fused(st, 1), p1, cfg)
    nxt = (st.it // cfg.rho_change_step + 1) * cfg.rho_change_step
    k1_planted("xl tail: rho of the next schedule step",
               fused(st.replace(it=nxt), 1), p1, cfg)

    _, tk = fused(st, W, record=True)
    worst, slot_errs = {}, []
    for t in range(W):
        s_t = st if t == 0 else fused(st, t)
        if t:
            require(bool((tk[..., t - 1] == s_t.x).all()),
                    f"K1 xl tail: slot {t - 1} is not the kernel's state "
                    f"after {t} iterations")
        p, tpl = plain(s_t, 1, record=True)
        slot_errs.append((tk[..., t] - tpl[..., 0]).abs().max().item())
        require(slot_errs[-1] <= K1_TOL,
                f"K1 xl tail slot {t}: {slot_errs[-1]:.3e}")
        for f, e in compare(f"xl-tail-{side}-it{t}", fused(s_t, 1), p, cfg,
                            quiet=True).items():
            worst[f] = max(worst.get(f, 0.0), e[1])
    log(f"  K1 xl tail, {W} iterations each from the kernel's state: "
        f"trajectory slots max abs err {max(slot_errs):.2e}; state in x "
        "units, worst over the iterations: "
        + " ".join(f"{f}={e:.2e}" for f, e in worst.items()))
    log(f"  K1 xl tail: routes {pair.routes}, each launch equal bit for bit "
        "to its f32-stream launch")
    amp = k1_errors(plain(fused(st, 1), W - 1), plain(p1, W - 1), cfg)
    straight = k1_errors(fused(st, W), plain(st, W), cfg)
    log(f"  K1 xl tail, not held: the kernel's and the plain version's "
        f"states after 1 iteration, each run on {W - 1} iterations by the "
        "plain version, in x units: "
        + " ".join(f"{f}={e[1]:.2e}" for f, e in amp.items())
        + f"; one {W}-iteration launch against the plain version: "
        + " ".join(f"{f}={e[1]:.2e}" for f, e in straight.items()))
    # on clusters: at the path's live count, with the plan's C (what the
    # path's first tail launch ran), and at 15 live (C = 8)
    return k1_cluster_check(st, prob, cfg, nfactor, fused_lp, compare,
                            (int((~st.done).sum()), 15), "xl-tail", False,
                            W)


def k1_cluster(s, prob, cfg, window, C, nfactor, fused_lp, E_op):
    """``window`` K1 iterations from ``s`` on clusters of ``C`` blocks an
    instance (``window_cuda``; not counted in the path's launches)."""
    a = fused_lp.window_inputs(s, prob, cfg, nfactor, E_op)._replace(
        cluster=C)
    out = fused_lp.window_cuda(a, cfg, s.it, window)
    return fused_lp.window_state(s, prob, cfg, window, out, False)


def k1_cluster_check(st, prob, cfg, nfactor, fused_lp, compare, lives, tag,
                     hold_straight, W=20):
    """K1 on clusters against its plain version from ``st``, for each
    live count in ``lives``: the instances after the first ``live`` that
    are not done in ``st`` are marked done, and C is the plan the card
    gives that count (``split_plan``), as on the main path.  Held: each
    of W iterations from the kernel's own state against one plain
    iteration from that state (every state field within K1_TOL); a
    repeat W-iteration launch gives the same bits; done instances come
    back as they went in (E x as the one-block launch gives it); the
    one W-iteration launch against the plain version, held where
    ``hold_straight`` and logged otherwise (from a late state the
    iteration amplifies a difference); and a planted fault, the rows of
    E of one block's share zeroed (the block whose rows hold the most
    entries of the live instances), which must cross K1_TOL after one
    iteration.  Returns (live, C, factor rows resident) per case."""
    import torch
    B, m, n = prob.E.shape
    nside = nfactor is not None
    E_op = fused_lp.window_operand(prob.E, cfg)
    route = fused_lp.e_route(E_op)
    hw = fused_lp.card(prob.E.device)
    plain = lambda s, w: fused_lp.lp_window_plain(s, prob, cfg, w,
                                                  nfactor=nfactor)
    cases = []
    for live in lives:
        idx = torch.nonzero(~st.done).flatten()
        require(idx.numel() >= live, f"K1 {tag}: {live} live instances")
        done = torch.ones_like(st.done)
        done[idx[:live]] = False
        s0 = st.replace(done=done)
        C = fused_lp.split_plan(live, m, n, nside, route, hw.sms,
                                hw.max_active)
        require(C > 1, f"K1 {tag}: {live} live take a cluster (plan {C})")
        res = fused_lp.factor_resident(m, n, route, C, nside)
        name = f"cluster-{tag}-{live}live-C{C}{'-res' if res else ''}"
        run = lambda s, w, E=E_op: k1_cluster(s, prob, cfg, w, C, nfactor,
                                              fused_lp, E)
        k = run(s0, W)
        k1_same_bits(k, run(s0, W), False, f"K1 {name}: repeat launch")
        one = k1_cluster(s0, prob, cfg, W, 1, nfactor, fused_lp, E_op)
        frozen = {"x": s0.x, "y1": s0.x, "y2": s0.x, "y3": s0.f_eff,
                  "z1": s0.z1, "z2": s0.z2, "z4": s0.z4,
                  "best_sol": s0.best_sol, "obj_ring": s0.obj_ring,
                  "obj_count": s0.obj_count, "cur_obj": s0.cur_obj,
                  "best_bin_obj": s0.best_bin_obj, "ex": one.ex}
        moved = [f for f, v in frozen.items()
                 if not torch_equal(getattr(k, f)[done], v[done])]
        require(not moved, f"K1 {name}: done instances changed {moved}")
        worst, s_t = {}, s0
        for t in range(W):
            k_t = run(s_t, 1)
            for f, e in compare(f"{name}-it{t}", k_t, plain(s_t, 1), cfg,
                                quiet=True).items():
                worst[f] = max(worst.get(f, 0.0), e[1])
            s_t = k_t
        if hold_straight:
            straight = compare(f"{name}-{W}it", k, plain(s0, W), cfg)
        else:
            straight = k1_errors(k, plain(s0, W), cfg)
        held = "held" if hold_straight else "not held"
        log(f"  K1 {name} ({B}, {m}, {n}) {'n' if nside else 'm'} side, it "
            f"{st.it}: {W} iterations each from the kernel's state, worst "
            "in x units " + " ".join(f"{f}={e:.2e}" for f, e in
                                     worst.items())
            + f"; one {W}-iteration launch ({held}) "
            + " ".join(f"{f}={e[1]:.2e}" for f, e in straight.items()))
        share = fused_lp.share_rows(m, C)
        mass = [float(E_op[idx[:live], r * share:(r + 1) * share]
                      .abs().sum()) for r in range(C)]
        r = max(range(C), key=mass.__getitem__)
        bad = E_op.clone()
        bad[:, r * share:(r + 1) * share] = 0
        k1_planted(f"{name}: E's rows of block {r} zeroed",
                   k1_cluster(s0, prob, cfg, 1, C, nfactor, fused_lp, bad),
                   plain(s0, 1), cfg)
        cases.append((live, C, res))
    return cases


def cuda_ms_cold(fn, reps, flush):
    """Mean milliseconds of one call of ``fn`` on the card with L2 cold:
    before each call ``flush`` (1 GiB, against the 50 MB L2) is read, as
    the sweep reads E before each G^{-1} apply in the solve, leaving L2
    clean (a write would leave dirty lines whose write-back the timed
    call pays).  The read (~0.3 ms) also keeps the card busy while the
    host prepares the call, so the events around the call time the
    device's work and not the wrapper's host time."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def rel_to_ref(a, b):
    """max |a - b| / max(1, max |b|)."""
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


K3_ROWS = [f"{f}_{br}" for f in ("x", "z1", "z2", "y1", "base", "shift")
           for br in ("keep", "exact")]


def k3_errors(k, p):
    """Per output of a sweep, its error relative to max(1, max |ref|)."""
    out = {name: rel_to_ref(k.V[:, r], p.V[:, r])
           for r, name in enumerate(K3_ROWS)}
    out["F"] = rel_to_ref(k.F, p.F)
    out["acc"] = max(rel_to_ref(k.acc[:, i], p.acc[:, i])
                     for i in range(k.acc.shape[1]))
    return out


def k3_check(prob0, cfg, lp, fused_stream):
    """K3 against its plain version on the first xl block (bf16 E): one
    sweep from the state after 24 iterations (rho steps at the next
    one), two planted faults the limit must catch, a repeat launch and
    the f32-E launch bit for bit, and 20 iterations of the stream window
    with the kernel against the window with the plain sweep."""
    import torch
    s0 = lp.init_state(prob0, cfg)
    E16 = fused_stream.stream_operand(prob0.E, cfg)
    s24 = fused_stream.lp_window_stream_plain(s0, prob0, cfg, 24,
                                              skip_cvg_at=0, E_op=E16)
    carry = fused_stream._bootstrap(s24, prob0, cfg)
    free_f = s24.free.float()
    args = fused_stream._sweep_args(carry, E16, prob0, free_f, cfg)
    k = fused_stream.sweep_cuda(*args)
    p = fused_stream.sweep_plain(*args)
    errs = k3_errors(k, p)
    log("  K3 one sweep (8, 1664, 4096) bf16 E, error / max(1, max|ref|): "
        + " ".join(f"{f}={e:.2e}" for f, e in errs.items()))
    require(finite(*k), "K3: finite")
    require(max(errs.values()) <= K3_TOL,
            f"K3 sweep over {K3_TOL:g}: {errs}")

    rho, rho_nx = args[-3], args[-1]
    require(rho_nx != rho, "K3 check: rho steps at the next iteration")
    bad = k3_errors(fused_stream.sweep_cuda(*args[:-1], rho), p)
    log(f"  K3 planted fault rho_next = rho: largest {max(bad.values()):.2e}")
    require(max(bad.values()) > K3_TOL,
            f"K3 limit {K3_TOL:g} misses the planted fault rho_next = rho")
    V = p.V
    A = torch.stack([V[:, 8], V[:, 10], free_f * V[:, 6],
                     free_f * (V[:, 0] >= 0.5).float(), V[:, 9], V[:, 11],
                     free_f * V[:, 7], free_f * (V[:, 1] >= 0.5).float()], 1)
    j0 = prob0.n // 2
    tile = slice(j0, j0 + 32)
    F_bad = k.F - torch.bmm(A[:, :, tile],
                            prob0.E[:, :, tile].float().transpose(1, 2))
    bad_f = rel_to_ref(F_bad, p.F)
    log(f"  K3 planted fault F without columns {j0}..{j0 + 31}: {bad_f:.2e}")
    require(bad_f > K3_TOL,
            f"K3 limit {K3_TOL:g} misses the planted fault of a lost tile")
    again = fused_stream.sweep_cuda(*args)
    f32 = fused_stream.sweep_cuda(prob0.E, *args[1:])
    require(all(torch.equal(a, b) for a, b in zip(k, again)),
            "K3 repeat launch: same bits")
    require(all(torch.equal(a, b) for a, b in zip(k, f32)),
            "K3 bf16 E and f32 E: same bits")

    kw = fused_stream.lp_window_stream(s0, prob0, cfg, 20, skip_cvg_at=0,
                                       E_op=E16)
    pw = fused_stream.lp_window_stream_plain(s0, prob0, cfg, 20,
                                             skip_cvg_at=0, E_op=E16)
    werrs = k1_errors(kw, pw, cfg)
    require(bool((kw.done == pw.done).all()) and kw.it == pw.it == 20,
            "K3 window: done flags and iterations")
    log("  K3 20-iteration window vs plain sweep, in x units: "
        + " ".join(f"{f}={e[1]:.2e}" for f, e in werrs.items()))
    over = k1_excess(werrs)
    require(not over, f"K3 window: {over} over {K1_TOL:g}")
    # largest absolute error of the O(1) outputs: x and y1 of one sweep,
    # x and its copies after 20 iterations
    max_abs = max([(k.V[:, r] - p.V[:, r]).abs().max().item()
                   for r in (0, 1, 6, 7)]
                  + [werrs[f][0] for f in K1_ABS])
    return {"max_abs_err": max_abs, "sweep": errs,
            "window_x_units": max(e[1] for e in werrs.values())}, \
        s0, E16, args, carry


def k4_check(prob0, s0, carry, symm):
    """K4 against its plain version and the dense product on the first
    block's G^{-1} (8, 1664, 1664), and a repeat launch bit for bit.  Two
    vectors: a seeded normal one, held to K4_TOL of max |ref|; and E rhs
    of the check's state, the vector the solve applies G^{-1} to, held to
    K4_TOL of the terms' scale max_i sum_j |G_ij| |v_j|, because there
    G^{-1} v cancels terms about 300x larger than the result (measured on
    the CPU at this shape: f32 against f64, the dense product itself is
    off by 2.8e-5 of max |ref|)."""
    import torch
    Gp = symm.pack_tril(s0.ginv)
    g = torch.Generator("cuda").manual_seed(0)
    vecs = {"normal": torch.randn(carry.rhs.shape[0], prob0.m, device="cuda",
                                  generator=g),
            "E rhs": torch.bmm(prob0.E.float(), carry.rhs[..., None])[..., 0]}
    errs, max_abs = {}, 0.0
    for name, v in vecs.items():
        y = symm.symm_matvec_cuda(Gp, v)
        require(finite(y), f"K4 {name}: finite")
        scale = (torch.bmm(s0.ginv.abs(), v.abs()[..., None]).max().item()
                 if name == "E rhs" else None)
        for ref_name, ref in (("plain", symm.symm_matvec_plain(Gp, v)), (
                "dense bmm", torch.bmm(s0.ginv, v[..., None])[..., 0])):
            d = (y - ref).abs().max().item()
            errs[f"{name} vs {ref_name}"] = d / (scale or
                                                 ref.abs().max().item())
            if ref_name == "plain":
                max_abs = max(max_abs, d)
        require(torch.equal(y, symm.symm_matvec_cuda(Gp, v)),
                f"K4 {name}: repeat launch, same bits")
    log(f"  K4 (8, 1664), packed {tuple(Gp.shape)}: "
        + " ".join(f"{k}={e:.2e}" for k, e in errs.items()))
    require(max(errs.values()) <= K4_TOL, f"K4 over {K4_TOL:g}: {errs}")
    return {"max_abs_err": max_abs, "errs": errs}, Gp, vecs["E rhs"]


def probe_operands(probe_dot):
    """The probe's operands on the card, per shape: ``probe`` (8, 256,
    256) from the JAX script's own draw (``make_inputs``), and ``xl``
    PROBE_XL, the xl block shape K3 sweeps, drawn on the card from a
    seeded ``torch.Generator`` (uniform on [0, 1) as ``rand`` is), so no
    host set-up is added."""
    import torch
    E_np, v_np = probe_dot.make_inputs()
    ops = {"probe": (torch.from_numpy(E_np).cuda(),
                     torch.from_numpy(v_np).cuda())}
    g = torch.Generator("cuda").manual_seed(0)
    bt, m, n = PROBE_XL
    ops["xl"] = (torch.rand(bt, m, n, device="cuda", generator=g),
                 torch.rand(bt, n, device="cuda", generator=g))
    return ops


def probe_check(probe_dot, ops):
    """P1-P3 at each shape of ``ops`` against their plain versions and the
    float64 einsum, to PROBE_TOL of max |ref|; a repeat launch bit for
    bit; and a planted fault the limit must catch: v[0, 0] raised so that
    the row of y where E[0, :, 0] is largest moves by 1.3x the limit (at
    the probe's shape that is about 1e-3 of max |v|).  Returns the
    largest absolute errors against the plain versions, per shape."""
    import torch
    errs = {}
    for label, (E, v) in ops.items():
        want = torch.einsum("bmn,bn->bm", E.double(), v.double())
        scale = want.abs().max().item()
        v_bad = v.clone()
        v_bad[0, 0] += 1.3 * PROBE_TOL * scale / E[0, :, 0].max()
        errs[label] = {}
        for name in probe_dot.NAMES:
            y = probe_dot.launch(name, E, v)
            plain = probe_dot.PLAIN[name](E, v)
            e_plain = (y - plain).abs().max().item()
            e_ref = (y.double() - want).abs().max().item()
            bad = (probe_dot.launch(name, E, v_bad) - plain).abs().max().item()
            log(f"  {name} {tuple(E.shape)}: max abs err vs plain "
                f"{e_plain:.3e}, vs f64 einsum {e_ref:.3e} = "
                f"{e_ref / scale:.2e} of max |ref| (limit "
                f"{PROBE_TOL * scale:.3e}); planted fault {bad:.3e}")
            require(finite(y), f"{name} {label}: finite")
            require(max(e_plain, e_ref) <= PROBE_TOL * scale,
                    f"{name} {label} over {PROBE_TOL:g} of max |ref|")
            require(bad > PROBE_TOL * scale,
                    f"{name} {label}: limit misses the planted fault")
            require(torch.equal(y, probe_dot.launch(name, E, v)),
                    f"{name} {label}: repeat launch, same bits")
            errs[label][name] = e_plain
    return errs


def stream_split(s0, prob0, cfg, E16, fused_stream, W=100):
    """One window of W iterations from the solve's start, run as
    ``lp_window_stream`` runs it, with CUDA events around each sweep (K3)
    and each glue; then the same window without the per-iteration read
    of the all-done flag; then 20 iterations under the profiler for the
    card's busy time per iteration.  Event spans include the card's idle
    time while the host enqueues; the idle share is 1 - busy / wall."""
    import torch
    free_f = s0.free.float()
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
           for _ in range(W)]
    carry = fused_stream._bootstrap(s0, prob0, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e0, e1, e2 in evs:
        if bool(carry.state.done.all()):
            break
        e0.record()
        outs = fused_stream.sweep_cuda(*fused_stream._sweep_args(
            carry, E16, prob0, free_f, cfg))
        e1.record()
        carry = fused_stream._glue(carry, outs, prob0, cfg, 0)
        e2.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = sum(e0.elapsed_time(e1) for e0, e1, _ in evs)
    glue = sum(e1.elapsed_time(e2) for _, e1, e2 in evs)
    carry = fused_stream._bootstrap(s0, prob0, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(W):
        outs = fused_stream.sweep_cuda(*fused_stream._sweep_args(
            carry, E16, prob0, free_f, cfg))
        carry = fused_stream._glue(carry, outs, prob0, cfg, 0)
    torch.cuda.synchronize()
    wall_noflag = time.perf_counter() - t0
    # the card's busy time: kernels of WP iterations under the profiler
    WP = 20
    carry = fused_stream._bootstrap(s0, prob0, cfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(WP):
            if bool(carry.state.done.all()):
                break
            outs = fused_stream.sweep_cuda(*fused_stream._sweep_args(
                carry, E16, prob0, free_f, cfg))
            carry = fused_stream._glue(carry, outs, prob0, cfg, 0)
        torch.cuda.synchronize()
    evs_k = prof.key_averages()
    busy = sum(e.self_device_time_total for e in evs_k) / 1e3 / WP
    k3_dev = sum(e.self_device_time_total for e in evs_k
                 if "sweep_kernel" in e.key or "finish_kernel" in e.key) \
        / 1e3 / WP
    kernels = sum(e.count for e in evs_k if e.self_device_time_total > 0) \
        / WP
    return {"iters": W, "k3_ms_per_it": k3 / W, "glue_ms_per_it": glue / W,
            "wall_ms_per_it": wall * 1e3 / W,
            "wall_ms_per_it_no_flag": wall_noflag * 1e3 / W,
            "device_busy_ms_per_it": busy, "k3_device_ms_per_it": k3_dev,
            "device_kernels_per_it": kernels,
            "device_idle_share": 1.0 - busy / (wall * 1e3 / W)}


# --- the dense-LP options (CA-500) ------------------------------------------
# The three-limb bfloat16 products (core.lp._mv, the JAX package's _emv)
# against the float32 product on the same inputs: 1e-6 of max |ref| (three
# limbs carry 24 mantissa bits, the f32 sums differ in order); one limb
# (the planted fault) misses it by three orders (its 8 bits give 4e-3).
EMV_TOL = 1e-6
# solve(rule_fixing=True) on the first RULE_FIX_BATCH instances at the
# solver's defaults (core.lp windows: 10 800 iterations in 28 s on an
# H100 80GB HBM3 at 700 W; its counters first fix after some 3000)
RULE_FIX_BATCH = 8


def emv_errors(lp, E, ginv, seed=0):
    """Relative errors of the bfloat16 products (E v, E^T w, G^{-1} r)
    against float32 on the card, and of the one-limb plant."""
    import torch
    g = torch.Generator(device=E.device).manual_seed(seed)
    B, m, n = E.shape
    V = torch.rand((B, 2, n), generator=g, device=E.device) * 4 - 2
    W = torch.rand((B, 4, m), generator=g, device=E.device) * 200 - 100
    E16, G16 = E.to(torch.bfloat16), ginv.to(torch.bfloat16)
    r = W[:, 0]
    errs = {"E v": rel_to_ref(lp._mv_many(E16, V), lp._mv_many(E, V)),
            "E^T w": rel_to_ref(lp._mtv_many(E16, W), lp._mtv_many(E, W)),
            "G^-1 r": rel_to_ref(lp._ginv_apply(G16, r),
                                 lp._mv(G16.float(), r))}
    one = lp._limbs3(V)[..., :1].permute(0, 2, 1, 3).reshape(B, n, 2)
    plant = lp._bf16_bmm(E16, one).transpose(1, 2)
    errs["one-limb E v (planted)"] = rel_to_ref(plant, lp._mv_many(E, V))
    return errs


def lp_options_phase(prob, st_plain, cfg, lp, fused_lp):
    """The dense-LP options on the CA-500 batch: the bfloat16 products
    (``emv_errors``), the bfloat16 G^{-1} store, ``solve(rule_fixing=
    True)`` on RULE_FIX_BATCH instances, and ``solve_auto`` (K1 route,
    the plain solve's objective bit for bit).  Returns (summary, K1
    launches of solve_auto)."""
    import torch
    out = {}
    ginv = st_plain.ginv
    errs = emv_errors(lp, prob.E, ginv)
    log("  bfloat16 products vs float32 (rel to max |ref|): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    plant = errs.pop("one-limb E v (planted)")
    require(max(errs.values()) <= EMV_TOL,
            f"three-limb products within {EMV_TOL:g}: {errs}")
    require(plant > EMV_TOL, f"one-limb plant misses {EMV_TOL:g}: {plant}")
    out["emv_errs"], out["emv_plant"] = errs, plant

    bcfg = cfg.replace(ginv_dtype="bfloat16")
    stored = lp._ginv_store(ginv, bcfg)
    back = stored.float()
    gerr = ((back - ginv).abs() / ginv.abs().clamp_min(1e-30)).max().item()
    log(f"  bfloat16 G^-1 store: {stored.dtype}, "
        f"{stored.nbytes / 2**20:.1f} MiB (f32 {ginv.nbytes / 2**20:.1f}), "
        f"round trip max rel {gerr:.2e} (one bf16 rounding <= 2^-8)")
    require(stored.dtype == torch.bfloat16 and gerr <= 2.0 ** -8
            and torch_equal(stored, ginv.to(torch.bfloat16)),
            "bfloat16 G^-1 store")
    s16 = lp.init_state(prob, bcfg)
    require(s16.ginv.dtype == torch.bfloat16, "init_state stores bf16")

    p8 = prob.replace(**{f: getattr(prob, f)[:RULE_FIX_BATCH] for f in (
        "b", "E", "f", "row_mask", "var_mask")})
    t0 = time.perf_counter()
    sr = lp.solve(p8, cfg, rule_fixing=True)
    _, robj, rinf = lp.select_solution(p8, lp.solution(sr),
                                       lp.solution_best(sr))
    torch.cuda.synchronize()
    fixes = (~sr.free & p8.var_mask).sum(-1)
    pobj = lp.objective_best(st_plain)[:RULE_FIX_BATCH]
    log(f"  solve(rule_fixing=True) on {RULE_FIX_BATCH} instances: "
        f"{time.perf_counter() - t0:.2f} s, it {sr.it}, fixes/instance "
        f"{fixes.float().mean().item():.1f} (min {int(fixes.min())}), "
        f"mean obj {robj.mean().item():.2f} (plain K1 incumbent "
        f"{pobj.mean().item():.2f}), infeasible instances "
        f"{int((rinf > 0).sum())}")
    require(int(fixes.min()) > 0, "rule fixing fixes variables")
    require(int((rinf > 0).sum()) == 0, "rule fixing: 0 infeasible")
    require(finite(robj, sr.x), "rule fixing: finite")
    out.update(rule_fix_it=sr.it, rule_fix_fixes=fixes.float().mean().item(),
               rule_fix_mean_obj=robj.mean().item())

    fused_lp.LAUNCHES.update(dict.fromkeys(fused_lp.E_ROUTES, 0))
    t0 = time.perf_counter()
    sa, path = lp.solve_auto(prob, cfg)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    k1 = sum(fused_lp.LAUNCHES.values())
    same = torch_equal(lp.objective(sa), lp.objective(st_plain))
    log(f"  solve_auto on the CA-500 batch: path {path}, {auto_s:.2f} s, it "
        f"{sa.it}, K1 launches {k1}, objective equal to solve_fused's bit "
        f"for bit: {same}")
    require(path == "k1" and k1 > 0 and same,
            "solve_auto takes K1 and gives solve_fused's objective")
    out.update(auto_path=path, auto_s=auto_s)
    return out, k1


# --- the very-large rung: the reference ladder's (1000, 1e5) instance ----
# The canonical instance of the JAX package's scripts/bench_sparse_rung.py
# (the first draw of RandomState(2207 + n_bids)); its float64 CPU oracle
# (bench_cache/cpu_oracle_1000_100000.json) is -98 792.28.  The plain
# struct solve at README's settings (rho_change_step 12, cap 6700); the
# struct l2f solve at scripts/mega_l2f.py's defaults with ca500_mha.
MEGA_ITEMS, MEGA_BIDS = 1000, 100000
MEGA_SHAPE, MEGA_NNZ = (19768, 100000), 559953
MEGA_RHO_STEP, MEGA_CAP = 12, 6700
# mega_l2f's train phase at a small rung: labels for two seeds (the
# rounding after 300 recorded iterations), one epoch from ca500_mha on
# the first, the second held out
MEGA_TRAIN_RUNG, MEGA_TRAIN_SEEDS = "100x1000", "1,2"
MEGA_POLICY_WINDOWS = 3
MEGA_GAP = 0.01                # l2f objective against the oracle
# struct products and the Schur apply against float64 on the host: 1e-5
# of max |ref| (f32 sums of at most a few hundred terms; the apply's
# f32 blocks are the float64 ones rounded once)
MEGA_TOL = 1e-5


def _generate_mega(path):
    import numpy as np
    sys.path.insert(0, ROOT)
    from lpbox_admm_tpu_torch.scripts import mega_l2f
    p, (r, c, v, s) = mega_l2f.generate(MEGA_ITEMS, MEGA_BIDS, "bench")
    np.savez(path, p=p, r=r, c=c, v=v, s=np.asarray(s))


def _generate_xl(path):
    """The 32 xl instances, each C (0/1) stored as bytes."""
    import numpy as np
    sys.path.insert(0, ROOT)
    from lpbox_admm_tpu_torch.adapters import ca
    rng = np.random.RandomState(XL_SEED)
    arrays = {}
    for i in range(XL_BATCH):
        p, C = ca.generate_cauction(rng, n_items=XL_ITEMS, n_bids=XL_BIDS)
        arrays[f"p{i}"], arrays[f"C{i}"] = p, C.astype(np.uint8)
    np.savez(path, **arrays)


class HostWorker:
    """Host numpy work (instance generation) in a spawned worker process
    while the card runs the earlier phases: ``target(path)`` writes an
    ``.npz``; ``result()`` waits for it and returns its arrays.
    ``close()`` stops the worker and removes its file."""

    def __init__(self, target, name):
        import multiprocessing
        import tempfile
        self.name = name
        self.dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        self.path = os.path.join(self.dir, f"{name}.npz")
        self.proc = multiprocessing.get_context("spawn").Process(
            target=target, args=(self.path,), daemon=True)
        self.proc.start()

    def result(self):
        import numpy as np
        self.proc.join()
        require(self.proc.exitcode == 0, f"{self.name} generation worker "
                f"exit code {self.proc.exitcode}")
        with np.load(self.path) as z:
            return {k: z[k] for k in z.files}

    def close(self):
        import shutil
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        shutil.rmtree(self.dir, ignore_errors=True)


def mega_instance(worker):
    """The canonical mega instance ``(prices, (rows, cols, vals, shape))``
    from its worker."""
    z = worker.result()
    return (z["p"], (z["r"], z["c"], z["v"], tuple(z["s"])))


def xl_instances(worker):
    """The xl instances ``[(prices, C)]`` from their worker, C in the
    generator's float64 (its 0/1 entries are exact in a byte)."""
    import numpy as np
    z = worker.result()
    return [(z[f"p{i}"], z[f"C{i}"].astype(np.float64))
            for i in range(XL_BATCH)]


def mega_checks(prob, ginv, inst, row_map, struct_ginv):
    """The struct products and the Schur apply on the card against
    float64 on the host (scipy), on seeded vectors."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    _, (r, c, v, shape) = inst
    E = prob.E
    C = sp.csr_matrix((np.asarray(v, np.float64), (row_map[r], c)),
                      shape=(E.m, E.n))
    rng = np.random.RandomState(0)
    x = rng.rand(E.n)
    w = rng.randn(E.m)
    t = lambda a: torch.from_numpy(a.astype(np.float32))[None].to(E.device)
    rel = lambda got, ref: float(np.abs(got - ref).max()
                                 / max(np.abs(ref).max(), 1e-30))
    errs = {"E v": rel(E.mv(t(x))[0].cpu().numpy(), C @ x),
            "E^T w": rel(E.mtv(t(w))[0].cpu().numpy(), C.T @ w)}
    sinv, Bm, dinv = struct_ginv.schur_blocks(C, E.m1, E.m2, 2.0)
    m1 = E.m1
    z2p = dinv * w[m1:]
    z1 = sinv @ (w[:m1] - Bm @ z2p)
    z = np.concatenate([z1, dinv * (w[m1:] - Bm.T @ z1)])
    got = ginv.apply(t(w))[0].cpu().numpy().astype(np.float64)
    errs["G^-1 r (Schur)"] = rel(got, z)
    G = C @ C.T + 2.0 * sp.eye(E.m)
    errs["G (G^-1 r) - r"] = rel(G @ got, w)
    return errs


def iteration_split(run, W=20):
    """``run(n)`` runs n iterations from one fixed start state: W of them
    timed on the host clock (synchronised) for the wall per iteration,
    then W under the profiler for the card's busy time and kernels per
    iteration; the idle share is 1 - busy / wall."""
    import torch
    run(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(W)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / W
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(W)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    busy = sum(e.self_device_time_total for e in evs) / 1e3 / W
    kernels = sum(e.count for e in evs if e.self_device_time_total > 0) / W
    return {"wall_ms_per_it": wall, "device_busy_ms_per_it": busy,
            "device_kernels_per_it": kernels,
            "device_idle_share": 1.0 - busy / wall}


def struct_split(prob, cfg, ginv, lp, W=20):
    """W iterations of the plain struct solve from its start."""
    s0 = lp.init_state(prob, cfg, ginv=ginv)
    return iteration_split(lambda n: lp.solve_window(
        s0, prob, cfg, n, record=False, skip_cvg_at=0), W)


def mega_phase(mega_inst, model, packed, pcfg, lp, fused_policy, l2f):
    """The very-large rung: the instance from the generation worker,
    ``make_struct_problem`` and ``build_struct_ginv``, the product checks,
    the plain struct solve through ``solve_auto`` and ``l2f_solve_struct``
    with K2 scoring every policy window (counts from 0 before it, read
    after it).  Returns (summary, K2 launches, the first policy window's
    rows)."""
    import numpy as np
    import torch
    from lpbox_admm_tpu_torch.config import LP_CONFIG
    from lpbox_admm_tpu_torch.ops import struct_ginv
    from lpbox_admm_tpu_torch.scripts import mega_l2f
    from lpbox_admm_tpu_torch.train import l2f_struct
    out = {}
    t0 = time.perf_counter()
    inst = mega_instance(mega_inst)
    _, (r, c, v, shape) = inst
    out["gen_wait_s"] = time.perf_counter() - t0
    log(f"  instance: C {tuple(shape)}, {len(r)} nonzeros (generated in a "
        f"worker; waited {out['gen_wait_s']:.2f} s)")
    require(tuple(shape) == MEGA_SHAPE and len(r) == MEGA_NNZ,
            f"the canonical (1000, 1e5) instance: {tuple(shape)}, {len(r)}")
    oracle = mega_l2f.oracle_obj(MEGA_ITEMS, MEGA_BIDS)
    require(oracle is not None, "the float64 CPU oracle is in the checkout")

    t0 = time.perf_counter()
    prob, ginv, row_maps = mega_l2f.build_struct(inst)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    E = prob.E
    log(f"  struct problem + Schur G^-1: {out['build_s']:.2f} s; m1 {E.m1} "
        f"m2 {E.m2} n {E.n}; device bytes E {E.nbytes() / 2**20:.1f} MiB, "
        f"G^-1 {ginv.nbytes() / 2**20:.1f} MiB (dense f32 E would be "
        f"{E.m * E.n * 4 / 2**30:.2f} GiB, dense G^-1 "
        f"{E.m * E.m * 4 / 2**30:.2f} GiB)")
    out.update(m1=E.m1, m2=E.m2, e_mib=E.nbytes() / 2**20,
               ginv_mib=ginv.nbytes() / 2**20)

    errs = mega_checks(prob, ginv, inst, row_maps[0], struct_ginv)
    log("  struct products on the card vs float64 (rel to max |ref|): "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    require(max(errs.values()) <= MEGA_TOL,
            f"struct products within {MEGA_TOL:g} of float64: {errs}")
    out["check_errs"] = errs

    cfg = LP_CONFIG.replace(linsolve="woodbury")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, path = lp.solve_auto(prob, cfg.replace(rho_change_step=MEGA_RHO_STEP),
                             max_iters=MEGA_CAP, ginv=ginv)
    _, pobj, pinf = lp.select_solution(prob, lp.solution(st),
                                       lp.solution_best(st))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    pobj, pinf = pobj.item(), int(pinf.item())
    log(f"  plain struct solve: path {path}, {plain_s:.2f} s, it {st.it} "
        f"({plain_s / max(st.it, 1) * 1e3:.3f} ms an iteration), done "
        f"{bool(st.done.all())}, obj {pobj:.2f}, gap to the oracle "
        f"{(pobj - oracle) / abs(oracle):+.4%}, infeasible rows {pinf}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(path == "windows-sparse", f"solve_auto's struct route: {path}")
    require(pinf == 0 and np.isfinite(pobj), "plain struct: 0 infeasible")
    out.update(plain_s=plain_s, plain_it=st.it, plain_obj=pobj,
               plain_gap=(pobj - oracle) / abs(oracle), plain_path=path)
    del st
    split = struct_split(prob, cfg.replace(rho_change_step=MEGA_RHO_STEP),
                         ginv, lp)
    log("  a struct iteration: " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()))
    out["plain_split"] = split

    first = {}
    score0 = l2f._scorer(model, pcfg, prob.device, 8192)

    def score(rows):
        first.setdefault("rows", rows)
        return score0(rows)

    fused_policy.LAUNCHES = 0
    tm = {}
    t0 = time.perf_counter()
    res = l2f_struct.l2f_solve_struct(
        prob, ginv, inst, row_maps[0], score, cfg,
        policy_windows=MEGA_POLICY_WINDOWS, oracle_obj=oracle, timings=tm)
    torch.cuda.synchronize()
    l2f_s = time.perf_counter() - t0
    k2 = fused_policy.LAUNCHES
    log(f"  l2f_solve_struct: {l2f_s:.2f} s (policy {res['policy_s']:.2f}, "
        f"compact {res['compact_s']:.2f}, tail {res['tail_s']:.2f}; "
        f"{ {k: round(x, 3) for k, x in tm.items()} }), tail on core.lp "
        f"windows, n {res['n_valid']} -> {res['n_red']} (reduced "
        f"{res['red_shape']}), decided {res['decided']}, fixed "
        f"{res['n_fixed']}, it {res['iterations']}, obj {res['obj']:.2f}, "
        f"gap to the oracle {res['gap']:+.4%}, infeasible rows "
        f"{res['infeasible']}, K2 launches {k2}")
    require(k2 >= MEGA_POLICY_WINDOWS,
            f"K2 scored every policy window: {k2} launches")
    require(res["infeasible"] == 0, "struct l2f: 0 infeasible")
    require(np.isfinite(res["obj"]) and res["gap"] <= MEGA_GAP,
            f"struct l2f within {MEGA_GAP:.0%} of the oracle: "
            f"{res['gap']:+.4%}")
    out.update(l2f_s=l2f_s, l2f_timings=tm,
               **{f"l2f_{k}": res[k] for k in (
                   "policy_s", "compact_s", "tail_s", "n_red",
                   "decided", "n_fixed", "iterations", "obj", "gap")})
    return out, k2, first["rows"]


def mega_train_check(fused_policy, l2f):
    """``mega_l2f --phase labels`` then ``--phase train`` (one epoch, the
    holdout proxy scored by K2: counts from 0 before it, read after it)
    at MEGA_TRAIN_RUNG in a temporary cache; the proxy is finite and the
    best checkpoint, read back through ``load_policy`` into K2, scores
    as the trained module does within K2_TOL.  Returns the summary and
    K2's launches."""
    import tempfile
    import numpy as np
    import torch
    from lpbox_admm_tpu_torch.config import PolicyConfig
    from lpbox_admm_tpu_torch.scripts import mega_l2f
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--rung", MEGA_TRAIN_RUNG, "--seeds", MEGA_TRAIN_SEEDS,
                  "--cache", tmp]
        t0 = time.perf_counter()
        mega_l2f.main(["--phase", "labels", "--cap", "300", "--record",
                       "300", "--rho-step", "12"] + common)
        labels_s = time.perf_counter() - t0
        fused_policy.LAUNCHES = 0
        t0 = time.perf_counter()
        res = mega_l2f.main(["--phase", "train", "--epochs", "1",
                             "--init-ckpt", CKPT] + common)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k2 = fused_policy.LAUNCHES
        proxy = res["best_proxy"]
        path = os.path.join(tmp, "mega_mha", "checkpoint",
                            "best_checkpoint.npz")
        back = load_policy(path, device="cuda")
        rows = torch.rand(4096, 100, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
        sk = fused_policy.policy_scores_cuda(
            fused_policy.pack_policy_weights(back), rows, 5)
        sm = l2f.policy_scores(res["state"].model.eval(), rows,
                               PolicyConfig(net="mha"))
        err = (sk - sm).abs().max().item()
    log(f"  mega train ({MEGA_TRAIN_RUNG}, seeds {MEGA_TRAIN_SEEDS}, the "
        f"last held out): labels {labels_s:.2f} s, one epoch and the "
        f"holdout proxy {train_s:.2f} s, loss "
        f"{res['history'][0]['loss']:.5f}, proxy {proxy:.5f}, K2 launches "
        f"{k2}; best checkpoint read back into K2: {err:.3e} from the "
        "trained module")
    require(np.isfinite(proxy), f"mega train: finite proxy {proxy}")
    require(k2 >= 3, f"mega train: K2 scored the holdout's windows: {k2}")
    require(finite(sk) and err <= K2_TOL,
            f"mega train: K2 of the best checkpoint {err:.3e}")
    return {"labels_s": labels_s, "train_s": train_s, "proxy": proxy,
            "loss": res["history"][0]["loss"], "k2_readback_err": err}, k2


# --- the segmentation workload ---------------------------------------------

SEG_CKPT = os.path.join(ROOT, "checkpoints", "seg_mha", "checkpoint",
                        "best_checkpoint.npz")
# the brute-force checks of tests/test_general.py (its CFG)
GENERAL_CFG = dict(initial_rho=5.0, learning_fact=1.03, rho_change_step=5,
                   stop_threshold=1e-3, std_threshold=1e-7, history_size=5,
                   gamma0=1.0, gamma_factor=0.99, max_iters=4000)


def qp_split(prob, cfg, qp, W=20):
    """W grid QP iterations from the start."""
    s0 = qp.init_state(prob, cfg)
    return iteration_split(lambda n: qp.solve_window(s0, prob, cfg, n,
                                                     record=False), W)


def brute_force(A, b, C=None, d=None, E=None, f=None):
    """The exhaustive optimum over feasible binary vectors (small n)."""
    import itertools
    import numpy as np
    X = np.array(list(itertools.product([0.0, 1.0], repeat=b.shape[0])))
    ok = np.ones(len(X), bool)
    if C is not None:
        ok &= np.all(np.isclose(X @ C.T, d), axis=1)
    if E is not None:
        ok &= np.all(X @ E.T <= f + 1e-9, axis=1)
    v = np.einsum("ki,ij,kj->k", X, A, X) + X @ b
    v[~ok] = np.inf
    return float(v.min())


def general_checks(general, SolverConfig):
    """The brute-force cases of tests/test_general.py on the card:
    unconstrained (n 10: never below the optimum, within half its spread
    above it), an equality (n 12, sum x = 4 exactly, ||Cx - d|| < 1e-6),
    an inequality (n 12, sum x <= 5, no violated row), both (sum of the
    first half = 2, sum x <= 6), and the equality's quality over four
    instances (mean gap to the optimum below 0.35 of |opt| + 1)."""
    import numpy as np
    cfg = SolverConfig(**GENERAL_CFG)
    rng = np.random.RandomState(0)

    def random_qp(n):
        M = rng.randn(n, n) * 0.5
        return (M + M.T) / 2, rng.randn(n) * 2

    def run(A, b, **blocks):
        p = general.make_general(A=A[None], b=b[None], device="cuda",
                                 **{k: v[None] for k, v in blocks.items()})
        st = general.solve(p, cfg, window=50)
        eq, ineq = general.constraint_violation(st, p)
        x = general.solution(st)[0].cpu().numpy()
        require(finite(st.x), "general: finite")
        return (x, general.objective(st, p).item(), eq.item(),
                int(ineq.item()), st.it)

    out = {}
    A, b = random_qp(10)
    x, obj, _, _, it = run(A, b)
    opt = brute_force(A, b)
    out["unconstrained"] = {"obj": obj, "opt": opt, "it": it}
    require(opt - 1e-4 <= obj <= opt + 0.5 * (abs(opt) + 1.0),
            f"general unconstrained: {obj} against the optimum {opt}")
    n = 12
    A, b = random_qp(n)
    C, d = np.ones((1, n)), np.array([4.0])
    x, obj, eq, _, it = run(A, b, C=C, d=d)
    out["equality"] = {"obj": obj, "opt": brute_force(A, b, C, d),
                       "sum": float(x.sum()), "eq": eq, "it": it}
    require(x.sum() == 4.0 and eq < 1e-6,
            f"general equality: sum {x.sum()}, ||Cx - d|| {eq}")
    A, b = random_qp(n)
    E, f = np.ones((1, n)), np.array([5.0])
    x, obj, _, ineq, it = run(A, b - 2.0, E=E, f=f)
    out["inequality"] = {"obj": obj, "opt": brute_force(A, b - 2.0, E=E, f=f),
                         "sum": float(x.sum()), "violated": ineq, "it": it}
    require(ineq == 0 and x.sum() <= 5,
            f"general inequality: {ineq} violated rows, sum {x.sum()}")
    A, b = random_qp(n)
    C = np.zeros((1, n))
    C[0, :6] = 1.0
    d, E, f = np.array([2.0]), np.ones((1, n)), np.array([6.0])
    x, obj, eq, ineq, it = run(A, b, C=C, d=d, E=E, f=f)
    out["both"] = {"obj": obj, "opt": brute_force(A, b, C, d, E, f),
                   "eq": eq, "violated": ineq, "it": it}
    require(eq < 1e-6 and ineq == 0 and x[:6].sum() == 2.0,
            f"general both: ||Cx - d|| {eq}, {ineq} violated rows, first "
            f"half {x[:6].sum()}")
    gaps = []
    for _ in range(4):
        A, b = random_qp(n)
        C4, d4 = np.ones((1, n)), np.array([4.0])
        x, obj, _, _, _ = run(A, b, C=C4, d=d4)
        if x.sum() == 4.0:
            opt = brute_force(A, b, C4, d4)
            gaps.append((obj - opt) / (abs(opt) + 1.0))
    out["equality_quality_gaps"] = gaps
    require(len(gaps) >= 2 and float(np.mean(gaps)) < 0.35,
            f"general equality quality: gaps {gaps}")
    return out


def seg_train_check(images, seg_pcfg, rows, fused_policy, l2f):
    """``run_seg -phase train`` through its ``main``: 1 epoch from
    seg_mha on the first 6 + 2 images (written as .npy, which the
    adapter reads without PIL), ``-eval_semantics full``; the loss is
    finite; the epoch's checkpoint, in the JAX package's format, read
    back into K2 on ``rows`` equals the trained module's forward within
    K2_TOL."""
    import tempfile
    import numpy as np
    from lpbox_admm_tpu_torch.experiments import run_seg
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        for i, im in enumerate(images):
            np.save(os.path.join(img_dir, f"{i}.npy"), im)
        lines = []
        res = run_seg.main(
            ["-phase", "train", "-image_dir", img_dir, "-n", "8",
             "-n_eval", "2", "-num_epochs", "1", "-init_checkpoint",
             SEG_CKPT, "-eval_semantics", "full", "-save_dir",
             os.path.join(tmp, "save"), "-result_dir",
             os.path.join(tmp, "result")], log=lines.append)
        for line in lines:
            log("    run_seg: " + line)
        loss = res["history"][0]["loss"]
        require(np.isfinite(loss), f"seg train: finite loss {loss}")
        path = os.path.join(tmp, "save", "checkpoint", "checkpoint_0.npz")
        back = load_policy(path, node_size=5, chunk_dim=5, device="cuda")
        packed = fused_policy.pack_policy_weights(back)
        sk = fused_policy.policy_scores_cuda(packed, rows, 1)
        sm = l2f.policy_scores(res["state"].model.eval(), rows, seg_pcfg)
        err = (sk - sm).abs().max().item()
        log(f"  seg train: loss {loss:.5f}, gap "
            f"{res['history'][0]['gap']:+.4%}, checkpoint read back into "
            f"K2 on {rows.shape[0]} rows: {err:.3e} from the trained "
            "module")
        require(finite(sk) and err <= K2_TOL,
                f"seg train: K2 of the written checkpoint {err:.3e}")
    return {"loss": loss, "gap": res["history"][0]["gap"],
            "best_gap": res["best_gap"], "k2_readback_err": err}


def k2_work(packed, rows):
    """K2's flops (2 x the FMAs of the encoder and the classifier a row)
    and bytes (rows and scores once, the packed weights once) on
    ``rows``, and the FMAs a row."""
    R = rows.shape[0]
    T, E = packed.peb.shape
    C = packed.w_top.shape[0]
    L = packed.wqkv.shape[0]
    F = packed.w1.shape[-1]
    fma_row = T * C * E + L * (T * E * 3 * E + 2 * T * T * E + T * E * E
                               + 2 * T * E * F) \
        + T * E * 256 + 256 * 128 + 128 * 16 + 16
    nbytes = rows.numel() * 4 + R * 4 + sum(t.numel() * 4 for t in packed)
    return 2.0 * fma_row * R, nbytes, fma_row


def k2_shape_timing(fused_policy, packed, op, rows, stride, what):
    """K2 at a path's own shape: ms a launch (CUDA events), its plain
    version, and the bound: 3 TF32 passes of its flops over
    PEAK_TF32_FLOPS against its bytes over PEAK_HBM_BYTES."""
    R, ws = rows.shape
    T = packed.peb.shape[0]
    C = packed.w_top.shape[0]
    run = lambda: fused_policy.policy_scores_cuda(packed, rows, stride, op)
    ms = cuda_ms(run, 5)
    plain_ms = cuda_ms(lambda: fused_policy.policy_scores_plain(
        packed, rows, stride), 1)
    flops, nbytes, fma_row = k2_work(packed, rows)
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES
    split = kernel_split(run, ("policy_encoder_kernel",
                               "policy_classifier_kernel"))
    log(f"  K2 at the {what} shape ({R} rows x ws {ws}, {T} tokens of {C} "
        f"at stride {stride}): {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{max(t_ops, t_bytes) * 1e3:.3f} ms (3 TF32 passes of "
        f"{flops:.3e} flop, {fma_row} FMA a row; {nbytes:.3e} B); per "
        "kernel " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    return {"shape": [R, ws, T, C, stride], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "per_kernel_ms": split}


def seg_phase(fused_policy, l2f):
    """The segmentation workload, 1e4 px and 1e5 px: the plain solve
    (with a profile of its iteration), the masked and the compacting l2f
    with seg_mha (K2 launches counted from 0 before them and read after
    them), the referee bounds at 1e4 px with a planted fault, K2 at the
    seg shape against its plain version on the 1e5-px first policy
    window's rows (and a row count that is not a multiple of 16), the
    general solver's brute-force checks and one run_seg training epoch.
    Returns the summary, K2's launches on the seg path and its timing."""
    import numpy as np
    import torch
    from lpbox_admm_tpu_torch.adapters import segmentation as seg
    from lpbox_admm_tpu_torch.config import (SEG_CONFIG, PolicyConfig,
                                             SolverConfig)
    from lpbox_admm_tpu_torch.core import general, qp
    from lpbox_admm_tpu_torch.train import imitation
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy

    cfg = SEG_CONFIG
    spcfg = PolicyConfig(node_size=5, chunk_dim=5, window_mode="sliding")
    model = load_policy(SEG_CKPT, node_size=5, chunk_dim=5, device="cuda")
    out, probs = {}, {}
    k2_launches = 0
    k2_rows = None
    for tag, seed, (H, W) in (("1e4", SEG_SEED, SEG_GRID),
                              ("1e5", SEG_SEED_XL, SEG_GRID_XL)):
        r = out[tag] = {"grid": [SEG_BATCH, H, W]}
        t0 = time.perf_counter()
        images = seg_images(seed, SEG_BATCH, H, W)
        prob = seg.make_problem(images, device="cuda")
        probs[tag] = (images, prob)
        r["make_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = imitation.build_dataset_qp(prob, cfg, record_iters=5 * SEG_WS,
                                        repair_sweeps=SEG_REPAIR,
                                        pair_sweeps=SEG_PAIR)
        energy = ds.oracle_obj.cpu().numpy()
        r.update(plain_s=time.perf_counter() - t0,
                 plain_solve_s=ds.oracle_wall_s, plain_iters=ds.oracle_iters,
                 plain_energy=energy.tolist(),
                 plain_ms_per_it=ds.oracle_wall_s * 1e3 / ds.oracle_iters)
        r["qp_iteration"] = qp_split(prob, cfg, qp)
        require(np.all(np.isfinite(energy)), f"seg {tag} plain: finite")
        log(f"  seg {tag} plain ({SEG_BATCH} x {H} x {W}): {ds.oracle_iters}"
            f" iterations, mean energy {energy.mean():.2f}, wall "
            f"{r['plain_s']:.2f} s (solve {ds.oracle_wall_s:.2f} s, "
            f"{r['plain_ms_per_it']:.3f} ms an iteration); a QP iteration "
            f"from the start: {r['qp_iteration']}")
        labels = ds.labels.reshape(prob.b.shape)
        solvers = {"masked": l2f.l2f_solve,
                   "compact": l2f.l2f_solve_compact_qp}
        # in turns, so that the two walls (run_seg's -compact rule on the
        # card) share the card's state: masked, compact, compact, masked
        for mode in ("masked", "compact", "compact", "masked"):
            fused_policy.LAUNCHES = 0
            with FirstCall(l2f, "policy_scores_fused") as first:
                t0 = time.perf_counter()
                st = solvers[mode](prob, model, cfg, spcfg, ws=SEG_WS,
                                   max_iter=SEG_MAX_ITER)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = fused_policy.LAUNCHES
            k2_launches += launches
            require(launches > 0, f"seg {tag} {mode}: K2 launched")
            if mode in r:
                r[mode]["walls_s"].append(wall)
                continue
            m = l2f.l2f_metrics_qp(st, prob, ds.oracle_obj, labels,
                                   repair_sweeps=SEG_REPAIR,
                                   pair_sweeps=SEG_PAIR)
            gap = m["energy_gap"].cpu().numpy()
            r[mode] = {"walls_s": [wall], "k2_launches": launches,
                       "it": st.it, "gap": gap.tolist(),
                       "gap_mean": float(gap.mean()),
                       "n_fixed": m["n_fixed"].tolist(),
                       "px_agree": m["px_agree"].tolist(),
                       "fix_errors": m["fix_errors"].tolist()}
            log(f"  seg {tag} l2f {mode}: wall {wall:.2f} s, {st.it} "
                f"iterations, gap mean {gap.mean():+.4%} max "
                f"{gap.max():+.4%}, pixels fixed mean "
                f"{m['n_fixed'].float().mean().item():.0f}, agreement "
                f"mean {m['px_agree'].float().mean().item():.0f}, fix "
                f"errors {m['fix_errors'].tolist()}, K2 launches {launches}")
            require(np.all(np.isfinite(gap)), f"seg {tag} {mode}: finite")
            if tag == "1e5" and mode == "masked":
                k2_rows = first.args[1]
        log(f"  seg {tag} walls in turns: masked "
            f"{[round(w, 4) for w in r['masked']['walls_s']]} s, compact "
            f"{[round(w, 4) for w in r['compact']['walls_s']]} s")

    # --- the referee at 1e4 px, and a planted fault that must cross it ----
    ref = SEG_REFEREE
    r = out["1e4"]
    e, e_ref = np.array(r["plain_energy"]), np.array(ref["plain_energy"])
    rel = np.abs(e - e_ref) / np.abs(e_ref)
    mean_rel = abs(e.mean() - e_ref.mean()) / abs(e_ref.mean())
    gap_d = abs(r["masked"]["gap_mean"] - ref["l2f_gap_mean"])
    fix_rel = abs(np.mean(r["masked"]["n_fixed"]) - np.mean(ref["l2f_fixed"])
                  ) / np.mean(ref["l2f_fixed"])
    images, prob = probs["1e4"]
    real_scorer = l2f._scorer

    def inverted(*a, **k):
        score = real_scorer(*a, **k)
        return lambda rows: 1.0 - score(rows)

    l2f._scorer = inverted
    try:
        st = l2f.l2f_solve(prob, model, cfg, spcfg, ws=SEG_WS,
                           max_iter=SEG_MAX_ITER)
    finally:
        l2f._scorer = real_scorer
    ds_gap = l2f.l2f_metrics_qp(st, prob, torch.tensor(e, device="cuda"),
                                repair_sweeps=SEG_REPAIR,
                                pair_sweeps=SEG_PAIR)["energy_gap"]
    fault_d = abs(ds_gap.mean().item() - ref["l2f_gap_mean"])
    out["referee"] = {"plain_rel": rel.tolist(), "plain_mean_rel": mean_rel,
                      "gap_mean": r["masked"]["gap_mean"],
                      "gap_mean_jax": ref["l2f_gap_mean"], "gap_d": gap_d,
                      "fixed_rel": fix_rel,
                      "fix_errors_jax": ref["l2f_fix_errors"],
                      "planted_gap_mean": ds_gap.mean().item(),
                      "planted_gap_d": fault_d}
    log(f"  seg referee (JAX on the CPU, same images): plain energy per "
        f"image {np.round(rel, 5).tolist()} (tol {SEG_IMAGE_TOL}), mean "
        f"{mean_rel:.5f} (tol {SEG_MEAN_TOL}); masked l2f gap mean "
        f"{r['masked']['gap_mean']:+.4%} against {ref['l2f_gap_mean']:+.4%} "
        f"({gap_d * 100:.3f} pp, tol {SEG_GAP_PP * 100:.1f}); pixels fixed "
        f"{fix_rel:.4f} (tol {SEG_FIX_TOL}); fix errors "
        f"{r['masked']['fix_errors']} against {ref['l2f_fix_errors']}; "
        f"planted fault (fix values inverted): gap mean "
        f"{ds_gap.mean().item():+.4%}, {fault_d * 100:.2f} pp off")
    require(np.all(rel <= SEG_IMAGE_TOL) and mean_rel <= SEG_MEAN_TOL,
            f"seg plain energies against the referee: {rel}, {mean_rel}")
    require(gap_d <= SEG_GAP_PP, f"seg l2f gap against the referee: {gap_d}")
    require(fix_rel <= SEG_FIX_TOL, f"seg pixels fixed: {fix_rel}")
    require(fault_d > SEG_GAP_PP, f"seg planted fault crosses the gap "
            f"bound: {fault_d}")

    # --- K2 at the seg shape on the 1e5-px first policy window's rows -----
    packed = fused_policy.pack_policy_weights(model)
    pop = fused_policy.policy_operand(packed)
    k2_err = k2_check(fused_policy, packed, pop, k2_rows, spcfg, l2f, model)
    odd = k2_rows[:k2_rows.shape[0] - 7]
    k2_err = max(k2_err, k2_check(fused_policy, packed, pop, odd, spcfg, l2f))
    k2 = k2_shape_timing(fused_policy, packed, pop, k2_rows, 1, "seg")
    k2.update(max_abs_err=k2_err, launches=k2_launches)

    out["general"] = general_checks(general, SolverConfig)
    log(f"  general (brute force, n <= 12): {out['general']}")
    images = probs["1e4"][0]
    rows4 = k2_rows[:80_000]
    out["train"] = seg_train_check(images, spcfg, rows4, fused_policy, l2f)
    return out, k2_launches, k2


# --- the sparse attack ------------------------------------------------------

def g_split(attack, model, x, tg, eps, Bm, nw, cfg, lam, W=20):
    """W attack G iterations from G = 1."""
    import torch
    return iteration_split(lambda n: attack.g_window(
        model, x, tg, eps, attack.init_attack_state(torch.ones_like(x)), Bm,
        nw, cfg, n, lam, record=False), W)


def attack_contract(res, k):
    """The attack's output contract: G binary, L0 = sum G, L0 <= 1.5 k,
    L-inf <= 1 (the JAX package's tests/test_attack.py)."""
    import numpy as np
    G = res["G"]
    B = G.shape[0]
    require(set(np.unique(G)) <= {0.0, 1.0}, "attack: G binary")
    require(np.all(res["L0"] == G.reshape(B, -1).sum(-1)), "attack: L0 = sum G")
    require(np.all(res["L0"] <= 1.5 * k), f"attack: L0 <= 1.5 k: {res['L0']}")
    require(np.all(res["Li"] <= 1.0 + 1e-6), "attack: L-inf <= 1")
    require(all(np.all(np.isfinite(res[n])) for n in ("L1", "L2", "Li")),
            "attack: finite norms")


def attack_oracle_check(attack, cifarnet, model, x, tg, Bm, nw, cfg):
    """The CNN oracle and the G iteration on the card against the port on
    the CPU, at ATTACK_WINDOW_LAMBDA: epsilon from ATTACK_WINDOW
    update_epsilon iterations on each side (from 0, G = 1), held to
    ATTACK_WINDOW_TOL; the loss gradient in epsilon and in G at the same
    inputs on both sides -- epsilon 0 (the clip's ties at every 0 and 1
    pixel) and the card's epsilon -- held to ATTACK_GRAD_TOL relative to
    the CPU's largest entry; then ATTACK_WINDOW G iterations from G = 1
    on each side from its own epsilon, every state field held to
    ATTACK_WINDOW_TOL.  The CNN term's reach -- how far it moves G over
    the window (the card at lambda1 0 against ATTACK_WINDOW_LAMBDA) --
    must pass ATTACK_REACH times that bound, so that the window check
    sees the card's convolutions."""
    import torch
    cpu = cifarnet.load_victim_npz(ATTACK_VICTIM, device="cpu")
    side = {"cuda": (model, x, tg, Bm, nw),
            "cpu": (cpu, x.cpu(), tg.cpu(), Bm.cpu(), nw.cpu())}
    ecfg = cfg.replace(maxIter_e=ATTACK_WINDOW)

    def lam(dev, v=ATTACK_WINDOW_LAMBDA):
        return torch.full((ATTACK_BATCH,), v, device=dev)

    eps = {dev: attack.update_epsilon(m, xs, t, torch.zeros_like(xs),
                                      torch.ones_like(xs), w, ecfg,
                                      lambda1=lam(dev))
           for dev, (m, xs, t, _, w) in side.items()}
    res = {"eps": (eps["cuda"].cpu() - eps["cpu"]).abs().max().item()}
    m_c, x_c, t_c, _, _ = side["cpu"]
    G1 = torch.ones_like(x_c)
    grads = {}
    for name, e, wrt in (("eps@0", torch.zeros_like(x_c), "eps"),
                         ("eps", eps["cuda"].cpu(), "eps"),
                         ("G", eps["cuda"].cpu(), "G")):
        gc = attack._loss_grad(m_c, x_c, t_c, e, G1, cfg, wrt)
        gd = attack._loss_grad(model, x, tg, e.cuda(), G1.cuda(), cfg, wrt)
        grads[name] = ((gd.cpu() - gc).abs().max()
                       / gc.abs().max()).item()
    res["grad_rel"] = grads

    def window(dev, lam_v):
        m, xs, t, b, w = side[dev]
        st, _ = attack.g_window(
            m, xs, t, eps[dev], attack.init_attack_state(torch.ones_like(xs)),
            b, w, cfg, ATTACK_WINDOW, lam(dev, lam_v), record=False)
        return st

    st = {dev: window(dev, ATTACK_WINDOW_LAMBDA) for dev in side}
    res["window"] = {f: (getattr(st["cuda"], f).cpu()
                         - getattr(st["cpu"], f)).abs().max().item()
                     for f in ("G", "y1", "y2", "y3", "z1", "z2", "z3", "z4")}
    res["reach"] = (st["cuda"].G - window("cuda", 0.0).G).abs().max().item()
    log(f"  CNN oracle, card vs CPU at lambda1 {ATTACK_WINDOW_LAMBDA:g}: "
        f"{ATTACK_WINDOW} epsilon iterations {res['eps']:.2e}; gradient "
        "relative to max |CPU| " + " ".join(
            f"{k}={v:.2e}" for k, v in grads.items())
        + f" (tol {ATTACK_GRAD_TOL:g})")
    log(f"  {ATTACK_WINDOW} G iterations, card vs CPU: " + " ".join(
        f"{f}={e:.2e}" for f, e in res["window"].items())
        + f" (tol {ATTACK_WINDOW_TOL:g}); the CNN term moves G by "
        f"{res['reach']:.2e} over them")
    require(res["eps"] <= ATTACK_WINDOW_TOL,
            f"attack: {ATTACK_WINDOW} epsilon iterations within "
            f"{ATTACK_WINDOW_TOL:g}: {res['eps']}")
    require(max(grads.values()) <= ATTACK_GRAD_TOL,
            f"attack: the CNN gradients within {ATTACK_GRAD_TOL:g}: {grads}")
    require(max(res["window"].values()) <= ATTACK_WINDOW_TOL,
            f"attack: {ATTACK_WINDOW} G iterations within "
            f"{ATTACK_WINDOW_TOL:g}: {res['window']}")
    require(res["reach"] >= ATTACK_REACH * ATTACK_WINDOW_TOL,
            f"attack: the CNN term moves G by {res['reach']:.2e}, under "
            f"{ATTACK_REACH} x the window bound")
    return res


def attack_phase(fused_policy, l2f):
    """The sparse attack at the full ATTACK_CONFIG on ATTACK_BATCH images:
    the CNN oracle and 20 G iterations on the card against the CPU
    (``attack_oracle_check``); one attack_single plain at init_lambda1
    and one l2f at lambda1 10 (K2's counts from 0 before each, read
    after) against the JAX package's CPU referee, with the planted fault
    (the policy's scores inverted) that must cross one of its bounds; K2
    against its plain version on the l2f run's own rows (B * 3072 x 50);
    the full l2f search with the repair (counts from 0 before it, read
    after) and its output contract; a profile of an epsilon and a G
    iteration.  Returns the summary, K2's launches on the attack path and
    its timing."""
    import numpy as np
    import torch
    from lpbox_admm_tpu_torch.adapters import attack
    from lpbox_admm_tpu_torch.config import ATTACK_CONFIG, PolicyConfig
    from lpbox_admm_tpu_torch.experiments import run_attack
    from lpbox_admm_tpu_torch.models import cifarnet
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy

    out = {}
    cfg = ATTACK_CONFIG.replace(segments=ATTACK_SEGMENTS,
                                lambda1_search_times=ATTACK_SEARCH_ROUNDS)
    pcfg = PolicyConfig(net="mha", node_size=10, chunk_dim=5)
    t0 = time.perf_counter()
    imgs = attack_images(ATTACK_SEED, ATTACK_BATCH)
    Bm_h = run_attack.group_masks(imgs, ATTACK_SEGMENTS)
    out["setup_s"] = time.perf_counter() - t0
    model = cifarnet.load_victim_npz(ATTACK_VICTIM, device="cuda")
    policy = load_policy(ATTACK_CKPT, node_size=10, chunk_dim=5,
                         device="cuda")
    x = torch.from_numpy(imgs).cuda()
    labels, _ = attack.predictions(model, x, torch.zeros_like(x),
                                   torch.ones_like(x), cfg)
    labels = labels.tolist()
    targets = [run_attack.target_of(t) for t in labels]
    tg = torch.tensor(targets, device="cuda")
    Bm = torch.from_numpy(Bm_h).cuda()
    nw = torch.ones_like(x)
    log(f"  {ATTACK_BATCH} images (0 px {int((imgs == 0).sum())}, 1 px "
        f"{int((imgs == 1).sum())}), SLIC {Bm_h.shape[1]} masks max, victim "
        f"labels {labels}, targets {targets} (setup {out['setup_s']:.2f} s)")
    require(labels == ATTACK_REFEREE["labels"],
            f"attack: the victim's labels on the card are the JAX "
            f"package's: {labels}")

    # --- the CNN oracle and 20 G iterations, card against the CPU ---------
    out["oracle"] = attack_oracle_check(attack, cifarnet, model, x, tg, Bm,
                                        nw, cfg)

    # --- the referee: attack_single plain at init_lambda1 and l2f at a
    # lambda1 where the policy decides L0 -------------------------------------
    def referee_run(mode, lam_v):
        lam = torch.full((ATTACK_BATCH,), lam_v, device="cuda")
        t0 = time.perf_counter()
        res = attack.attack_single(model, x, tg, Bm, nw, cfg, lam,
                                   use_l2f=mode != "plain",
                                   policy_model=policy, pcfg=pcfg)
        torch.cuda.synchronize()
        res = {k: v.cpu().numpy() for k, v in res.items()}
        return res, time.perf_counter() - t0

    def against(mode, res):
        ref = ATTACK_REFEREE[mode]
        diff = int((res["success"] != np.array(ref["success"])).sum())
        return diff, abs(res["L0"].mean() - np.mean(ref["L0"])) / cfg.k

    k2_launches = 0
    runs = {}
    lams = {"plain": cfg.init_lambda1,
            "l2f_at": ATTACK_REFEREE["l2f_at"]["lambda1"]}
    for mode, lam_v in lams.items():
        fused_policy.LAUNCHES = 0
        with FirstCall(l2f, "policy_scores_fused") as first:
            res, wall = referee_run(mode, lam_v)
        launches = fused_policy.LAUNCHES
        k2_launches += launches
        require(launches == (0 if mode == "plain" else 2),
                f"attack {mode}: K2 launched after windows 0 and 1 only: "
                f"{launches}")
        if mode == "l2f_at":
            k2_rows = first.args[1]
        diff, l0_d = against(mode, res)
        ref = ATTACK_REFEREE[mode]
        runs[mode] = {"lambda1": lam_v, "wall_s": wall,
                      "k2_launches": launches,
                      "success": res["success"].tolist(),
                      "L0": res["L0"].tolist(), "success_diff": diff,
                      "l0_d": l0_d}
        log(f"  attack_single {mode} at lambda1 {lam_v:g}: wall {wall:.2f} "
            f"s, success {res['success'].astype(int).tolist()}, L0 "
            f"{res['L0'].tolist()} (JAX on the CPU: success "
            f"{np.array(ref['success']).astype(int).tolist()}, L0 "
            f"{ref['L0']}); success differs on {diff} images (slack "
            f"{ATTACK_SUCCESS_SLACK}), mean L0 off by {l0_d:.4f} k (tol "
            f"{ATTACK_L0_TOL}); K2 launches {launches}")
        require(diff <= ATTACK_SUCCESS_SLACK,
                f"attack {mode}: success per image against the referee")
        require(l0_d <= ATTACK_L0_TOL,
                f"attack {mode}: mean L0 against the referee: {l0_d:.4f} k")
    out["referee"] = runs
    real_scorer = l2f._scorer

    def inverted(*a, **k):
        score = real_scorer(*a, **k)
        return lambda rows: 1.0 - score(rows)

    l2f._scorer = inverted
    try:
        bad, _ = referee_run("l2f_at", lams["l2f_at"])
    finally:
        l2f._scorer = real_scorer
    fault = against("l2f_at", bad)
    out["planted"] = {"success": bad["success"].tolist(),
                      "L0": bad["L0"].tolist(), "success_diff": fault[0],
                      "l0_d": fault[1]}
    log(f"  planted fault (policy scores inverted) at lambda1 "
        f"{lams['l2f_at']:g}: success {bad['success'].astype(int).tolist()}"
        f", L0 {bad['L0'].tolist()}; differs on {fault[0]} images, mean "
        f"L0 {fault[1]:.4f} k off the referee")
    require(fault[0] > ATTACK_SUCCESS_SLACK or fault[1] > ATTACK_L0_TOL,
            f"attack planted fault crosses a referee bound: {fault}")

    # --- K2 at the attack shape, on the rows of the l2f run whose L0 the
    # policy decides ------------------------------------------------------
    packed = fused_policy.pack_policy_weights(policy)
    pop = fused_policy.policy_operand(packed)
    k2_err = k2_check(fused_policy, packed, pop, k2_rows, pcfg, l2f, policy)
    k2 = k2_shape_timing(fused_policy, packed, pop, k2_rows, 5, "attack")

    # --- the full l2f search with the repair --------------------------------
    lines = []
    fused_policy.LAUNCHES = 0
    t0 = time.perf_counter()
    res = attack.attack_with_search(model, x, tg, Bm, nw, cfg, use_l2f=True,
                                    policy_model=policy, pcfg=pcfg,
                                    repair=True, log=lines.append)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    search_k2 = fused_policy.LAUNCHES
    k2_launches += search_k2
    for line in lines:
        log("    " + line)
    cut = ("" if ATTACK_SEARCH_ROUNDS == ATTACK_CONFIG.lambda1_search_times
           else f" (rounds cut from {ATTACK_CONFIG.lambda1_search_times} to "
           "fit the phase's deadline)")
    log(f"  l2f search ({ATTACK_SEARCH_ROUNDS} rounds{cut}, repair): wall "
        f"{search_s:.2f} s, asr {res['asr']:.3f}, mean L0 "
        f"{res['L0'].mean():.1f} L1 {res['L1'].mean():.3f} L2 "
        f"{res['L2'].mean():.4f} Linf {res['Li'].mean():.4f}, lambda1 "
        f"{res['lambda1'].tolist()}, K2 launches {search_k2}")
    require(search_k2 == 2 * ATTACK_SEARCH_ROUNDS,
            f"attack search: K2 launched twice a round: {search_k2}")
    attack_contract(res, cfg.k)
    out["search"] = {"wall_s": search_s, "rounds": ATTACK_SEARCH_ROUNDS,
                     "asr": res["asr"], "k2_launches": search_k2,
                     **{f"{n}_mean": float(np.mean(res[n]))
                        for n in ("L0", "L1", "L2", "Li")}}

    # --- where an epsilon and a G iteration's time goes -------------------
    lam0 = torch.full((ATTACK_BATCH,), cfg.lambda1, device="cuda")
    eps = attack.update_epsilon(model, x, tg, torch.zeros_like(x),
                                torch.ones_like(x), nw, cfg.replace(
                                    maxIter_e=ATTACK_WINDOW), lambda1=lam0)
    out["eps_iteration"] = iteration_split(
        lambda n: attack.update_epsilon(model, x, tg, eps, torch.ones_like(x),
                                        nw, cfg.replace(maxIter_e=n),
                                        lambda1=lam0))
    out["g_iteration"] = g_split(attack, model, x, tg, eps, Bm, nw, cfg, lam0)
    for what, name in (("eps", "an epsilon"), ("g", "a G")):
        log(f"  {name} iteration: " + ", ".join(
            f"{k} {v:.4f}" for k, v in out[f"{what}_iteration"].items()))
    k2.update(max_abs_err=k2_err, launches=k2_launches)
    return out, k2_launches, k2


def main():
    faulthandler.enable()
    faulthandler.dump_traceback_later(TOTAL_BUDGET_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    workers = {"mega": HostWorker(_generate_mega, "mega"),
               "xl": HostWorker(_generate_xl, "xl")}
    try:
        return run(workers)
    finally:
        for w in workers.values():
            w.close()


def run(workers):
    import numpy as np
    import torch
    from lpbox_admm_tpu_torch.adapters import ca
    from lpbox_admm_tpu_torch.config import LP_CONFIG, PolicyConfig
    from lpbox_admm_tpu_torch.core import lp
    from lpbox_admm_tpu_torch.kernels import build
    from lpbox_admm_tpu_torch.models import fused_policy
    from lpbox_admm_tpu_torch.ops import fused_lp, woodbury
    from lpbox_admm_tpu_torch.train import l2f
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LP_CONFIG.replace(linsolve="woodbury", incumbent_stride=8)
    pcfg = PolicyConfig(net="mha", fix_confidence=0.98, fix_windows=2,
                        damage_gate=0.25)
    summary = {}

    with Phase("device", 60):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        card = card_line()
        log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
            f"{count} device(s); {kind}; nvidia-smi: {card}")

    with Phase("build", 300) as ph:
        so = build.build()
        build.library()
        info = dict(build.BUILD_INFO)
        log(f"  nvcc build: {info['seconds']:.2f} s "
            f"({'cached' if info.get('cached') else 'cold'}) -> {so}")
        ptxas = ptxas_report(str(info.get("ptxas", "")))
        for name, r in ptxas.items():
            log(f"    ptxas: {name}: {r['registers']} registers, stack "
                f"frame {r['stack']} B, spill stores {r['spill_stores']} B, "
                f"loads {r['spill_loads']} B")
        hmma = sass_hmma(so)
        log(f"  SASS (cuobjdump): HMMA instructions {hmma}")
        require(len(hmma) == 2 and all(hmma.values()),
                f"both K2 kernels run on the tensor cores: {hmma}")
        if not info.get("cached"):
            path_k3 = ptxas.get("K3 sweep_kernel<bf16, RPT=4>")
            require(path_k3 is not None and path_k3["spill_stores"] == 0
                    and path_k3["spill_loads"] == 0,
                    f"K3 at the xl block spills no registers: {path_k3}")
            p1s = {k: r for k, r in ptxas.items() if k.startswith("P1 ")}
            require(len(p1s) == 2 and all(
                r["spill_stores"] == 0 and r["spill_loads"] == 0
                for r in p1s.values()),
                f"no P1 instance spills registers: {p1s}")
    summary["build_s"] = info["seconds"]
    summary["ptxas"] = ptxas
    summary["k2_sass_hmma"] = hmma
    summary["build_phase_s"] = ph.seconds

    with Phase("generate", 120) as ph:
        rng = np.random.RandomState(SEED)
        insts = [ca.generate_cauction(rng, n_items=N_ITEMS, n_bids=N_BIDS)
                 for _ in range(BATCH)]
        prob = ca.make_problem(insts, device="cuda")
        log(f"  {BATCH} CA-{N_BIDS} instances, E {tuple(prob.E.shape)}")
        require(tuple(prob.E.shape) == (BATCH, 256, 512), "CA-500 padding")
    summary["generate_s"] = ph.seconds

    with Phase("k1-check", 120) as ph:
        k1_res, rows, compare = k1_checks(prob, cfg, fused_lp, lp, woodbury)
    summary["k1_check_s"] = ph.seconds

    model = load_policy(CKPT, device="cuda")
    packed = fused_policy.pack_policy_weights(model)
    pop = fused_policy.policy_operand(packed)
    with Phase("k2-check", 60) as ph:
        k2_err = k2_check(fused_policy, packed, pop, rows, pcfg, l2f, model)
    summary["k2_check_s"] = ph.seconds

    # --- the probe: its checks, then its entry point with counts from 0 ----
    from lpbox_admm_tpu_torch.scripts import probe_dot
    with Phase("probe-dot", 60) as ph:
        probe_ops = probe_operands(probe_dot)
        probe_errs = probe_check(probe_dot, probe_ops)
        for name in probe_dot.NAMES:
            probe_dot.LAUNCHES[name] = 0
        probe_res = probe_dot.probe("cuda", out=lambda s_: log("  " + s_))
        probe_launches = dict(probe_dot.LAUNCHES)
        log(f"  probe entry point launches {probe_launches}")
        require(all(r["ok"] for r in probe_res.values()), "probe: all OK")
        require(all(probe_launches[k] > 0 for k in probe_dot.NAMES),
                f"probe launched every kernel: {probe_launches}")
    summary["probe_dot_s"] = ph.seconds

    # --- the main path: counts from 0, read after the l2f solve ---------
    zero_counts(fused_lp, fused_policy)
    with Phase("plain-solve", 180) as ph:
        st = fused_lp.solve_fused(prob, cfg, max_iters=cfg.max_iters,
                                  window=100)
        sol, plain_obj, plain_inf = lp.select_solution(
            prob, lp.solution(st), lp.solution_best(st),
            repair_rounds=REPAIR_ROUNDS, swap_rounds=SWAP_ROUNDS)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - ph.t0
        n_done = int(st.done.sum())
        log(f"  plain: wall {plain_s:.2f} s, it {st.it}, done "
            f"{n_done}/{BATCH}, mean obj {plain_obj.mean().item():.2f}, "
            f"infeasible instances {int((plain_inf > 0).sum())}, "
            f"K1 launches {sum(fused_lp.LAUNCHES.values())}")
        require(finite(plain_obj, sol), "plain: finite")
        require(int((plain_inf > 0).sum()) == 0, "plain: 0 infeasible")
        plain_routes = {k: v for k, v in fused_lp.LAUNCHES.items() if v}
        plain_launches = sum(plain_routes.values())
        log(f"  plain: K1 routes {plain_routes}")
        require(plain_launches > 0 and set(plain_routes) == {"int8-resident"},
                f"plain solve: every K1 launch int8-resident: {plain_routes}")
    summary.update(plain_s=plain_s, plain_it=st.it, plain_done=n_done,
                   plain_mean_obj=plain_obj.mean().item())

    with Phase("l2f-solve", 180) as ph, \
            FirstCall(l2f, "solve_fused_from") as ca_tail_in:
        tm = {}
        _, out = l2f.l2f_solve_compact(
            prob, model, cfg, pcfg, ws=100,
            policy_windows=3, rho_boost_iters=5000, max_iter=10000,
            repair_rounds=REPAIR_ROUNDS, swap_rounds=SWAP_ROUNDS,
            timings=tm)
        torch.cuda.synchronize()
        l2f_s = time.perf_counter() - ph.t0
        gap = (out["obj"] - plain_obj) / plain_obj.abs()
        n_inf = int((out["infeasible"] > 0).sum())
        launches = read_counts(fused_lp, fused_policy)
        log(f"  l2f: wall {l2f_s:.2f} s, timings {tm}, it "
            f"{out['iterations']}, gap mean {gap.mean().item():+.4%} max "
            f"{gap.max().item():+.4%}, fixes/instance "
            f"{out['n_fixed'].float().mean().item():.1f}, infeasible "
            f"instances {n_inf}, main-path launches {launches} (plain "
            f"solve {plain_launches})")
        require(finite(out["obj"], out["solution"]), "l2f: finite")
        require(n_inf == 0, "l2f: 0 infeasible")
        require(gap.mean().item() <= 0.02, "l2f mean gap <= +2%")
        require(launches["K1"] > 0 and launches["K2"] > 0,
                f"main path launched every kernel: {launches}")
        l2f_routes = {k: v for k, v in fused_lp.LAUNCHES.items() if v}
        log(f"  main path K1 routes {l2f_routes}")
        require(tm["policy_e_route"] == tm["tail_e_route"] == "int8-resident",
                f"l2f: K1 E routes int8-resident: {tm}")
        require(l2f_routes == {"int8-resident": launches["K1"]},
                f"main path: every K1 launch int8-resident: {l2f_routes}")
    summary.update(l2f_s=l2f_s, l2f_timings=tm,
                   l2f_gap_mean=gap.mean().item(),
                   l2f_gap_max=gap.max().item(),
                   l2f_fixes=out["n_fixed"].float().mean().item(),
                   l2f_it=out["iterations"])

    with Phase("k1-done-check", 60) as ph:
        n_frozen = k1_done_check(st, prob, cfg, fused_lp, compare)
        log(f"  K1 done-instance exit: {n_frozen} frozen instances")
        # K1 on clusters from the state the main path's tail handed K1
        # (after compaction and the rho fast-forward), at the live counts
        # of its later windows
        ca_tail = k1_cluster_check(
            *ca_tail_in.args[:3], ca_tail_in.kwargs.get("nfactor"),
            fused_lp, compare, (55, 30, 15), "ca500-tail", False)
        require({c for _, c, _ in ca_tail} == {2, 4, 8},
                f"ca500 tail clusters of 2, 4 and 8: {ca_tail}")
        k1_res["clusters at the ca500 tail"] = {"cases": ca_tail}
        del ca_tail_in
    summary["k1_done_check_s"] = ph.seconds

    # --- the dense-LP options; solve_auto's K1 launches from 0 -------------
    with Phase("lp-options", 120) as ph:
        summary["lp_options"], auto_k1 = lp_options_phase(prob, st, cfg, lp,
                                                          fused_lp)
    summary["lp_options_s"] = ph.seconds

    # --- training: the entry point and the compacting evaluation, counts
    # from 0 before each, read after each -----------------------------------
    with Phase("train", 300) as ph:
        summary["train"], train_launches, train_split_fn, train_rows = \
            train_phase(fused_lp, fused_policy, l2f)
    summary["train_s"] = ph.seconds

    # --- data parallelism: each rank's K1 and K2 counts from 0 before its
    # plain and its l2f solve, read after each --------------------------------
    with Phase("dp", DP_BUDGET_S) as ph:
        summary["dp"], dp_launches = dp_phase(prob, st, out, tm, gap,
                                              train_rows, DP_BUDGET_S)
    summary["dp_s"] = ph.seconds
    del train_rows

    # --- the large rung: the reference's xl instances --------------------
    from lpbox_admm_tpu_torch.ops import fused_stream, symm
    xcfg = LP_CONFIG.replace(linsolve="woodbury", matvec_dtype="bfloat16")
    with Phase("generate-xl", 240) as ph:
        xinsts = xl_instances(workers["xl"])
        wait_s = time.perf_counter() - ph.t0
        xprob = ca.make_problem(xinsts, device="cuda")
        log(f"  {XL_BATCH} CA-({XL_ITEMS}, {XL_BIDS}) instances (generated "
            f"in a worker; waited {wait_s:.2f} s), E "
            f"{tuple(xprob.E.shape)}, {xinsts[0][1].shape[0]} rows in the "
            "first")
        require(tuple(xprob.E.shape) == (XL_BATCH, 1664, 4096), "xl padding")
    summary["generate_xl_s"] = ph.seconds
    prob0 = xprob.replace(**{f: getattr(xprob, f)[:XL_BLOCK] for f in (
        "b", "E", "f", "row_mask", "var_mask")})

    with Phase("k3-check", 120) as ph:
        k3_res, s0x, E16, k3_args, carry = k3_check(prob0, xcfg, lp,
                                                    fused_stream)
    summary["k3_check_s"] = ph.seconds
    with Phase("k4-check", 60) as ph:
        k4_res, Gp, v4 = k4_check(prob0, s0x, carry, symm)
    summary["k4_check_s"] = ph.seconds

    # --- the xl solve: counts from 0, read after it ------------------------
    fused_stream.LAUNCHES = 0
    symm.LAUNCHES = 0
    with Phase("xl-solve", 300) as ph:
        torch.cuda.reset_peak_memory_stats()
        xst, iters = lp.solve_blocked(xprob, xcfg, block=XL_BLOCK,
                                      window=XL_WINDOW,
                                      max_iters=XL_MAX_ITERS, stream=True)
        torch.cuda.synchronize()
        xsolve_s = time.perf_counter() - ph.t0
        xl_launches = {"K3": fused_stream.LAUNCHES, "K4": symm.LAUNCHES}
        peak_solve = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        xsol, xobj, xinf = lp.select_solution(
            xprob, lp.solution(xst), lp.solution_best(xst),
            drop_rounds=XL_DROP, repair_rounds=XL_REPAIR,
            swap_rounds=XL_SWAP)
        torch.cuda.synchronize()
        select_s = time.perf_counter() - ph.t0 - xsolve_s
        peak_select = torch.cuda.max_memory_allocated()
        x_mean = xobj.mean().item()
        gap0 = (xobj[0].item() - XL_ORACLE_OBJ0) / abs(XL_ORACLE_OBJ0)
        x_inf = int((xinf > 0).sum())
        log(f"  xl solve: wall {xsolve_s:.2f} s, per-block iterations "
            f"{iters}, done {int(xst.done.sum())}/{XL_BATCH}, launches "
            f"{xl_launches}, peak memory {peak_solve / 2**30:.2f} GiB")
        log(f"  select (drop {XL_DROP}, repair {XL_REPAIR}, swap {XL_SWAP}): "
            f"{select_s:.2f} s, peak memory {peak_select / 2**30:.2f} GiB; "
            f"mean obj {x_mean:.2f} (TPU record {XL_TPU_MEAN_OBJ}), obj0 "
            f"{xobj[0].item():.2f}, gap0 vs CPU oracle {gap0:+.4%}, "
            f"infeasible instances {x_inf}")
        require(finite(xobj, xsol, xst.x), "xl: finite")
        require(x_inf == 0, "xl: 0 infeasible")
        require(xl_launches["K3"] > 0, f"xl path launched K3: {xl_launches}")
        require(x_mean <= 0.9 * XL_TPU_MEAN_OBJ,
                f"xl mean objective {x_mean:.1f} within 10% of "
                f"{XL_TPU_MEAN_OBJ}")
        split = stream_split(s0x, prob0, xcfg, E16, fused_stream)
        log("  one 100-iteration window of the first block: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    summary.update(xl_solve_s=xsolve_s, xl_select_s=select_s,
                   xl_iters=iters, xl_mean_obj=x_mean, xl_gap0=gap0,
                   xl_peak_gib_solve=peak_solve / 2**30,
                   xl_peak_gib_select=peak_select / 2**30, xl_split=split)

    # --- a packed-symmetric window: counts from 0, read after it -----------
    fused_stream.LAUNCHES = 0
    symm.LAUNCHES = 0
    with Phase("xl-symm", 120) as ph:
        scfg = xcfg.replace(ginv_apply="packed-sym")
        ws = fused_stream.lp_window_stream(s0x, prob0, scfg, XL_WINDOW,
                                           skip_cvg_at=0, E_op=E16)
        torch.cuda.synchronize()
        symm_s = time.perf_counter() - ph.t0
        sym_launches = {"K3": fused_stream.LAUNCHES, "K4": symm.LAUNCHES}
        require(finite(ws.x, ws.z4), "xl-symm: finite")
        require(sym_launches["K3"] > 0 and sym_launches["K4"] > 0,
                f"packed-sym path launched K3 and K4: {sym_launches}")
        ks = fused_stream.lp_window_stream(s0x, prob0, scfg, 20,
                                           skip_cvg_at=0, E_op=E16)
        kd = fused_stream.lp_window_stream(s0x, prob0, xcfg, 20,
                                           skip_cvg_at=0, E_op=E16)
        serrs = k1_errors(ks, kd, xcfg)
        log(f"  packed-sym window: {ws.it} iterations in {symm_s:.2f} s, "
            f"launches {sym_launches}; first 20 iterations vs the dense "
            "apply, in x units: "
            + " ".join(f"{f}={e[1]:.2e}" for f, e in serrs.items()))
        over = k1_excess(serrs)
        require(not over, f"packed-sym window: {over} over {K1_TOL:g}")
    summary.update(xl_symm_s=symm_s, xl_symm_it=ws.it)

    # --- the xl l2f solve: counts from 0, read after it --------------------
    del xst, xsol, ws
    zero_counts(fused_lp, fused_policy)
    with Phase("xl-l2f", 240) as ph, \
            FirstCall(l2f, "policy_scores_fused") as k2_in, \
            FirstCall(l2f, "solve_fused_from") as tail_in:
        torch.cuda.reset_peak_memory_stats()
        xtm = {}
        _, xout = l2f.l2f_solve_compact(
            xprob, model, cfg, pcfg, ws=100,
            policy_windows=3, rho_boost_iters=5000, max_iter=10000,
            repair_rounds=REPAIR_ROUNDS, swap_rounds=SWAP_ROUNDS,
            timings=xtm)
        torch.cuda.synchronize()
        xl2f_s = time.perf_counter() - ph.t0
        peak_l2f = torch.cuda.max_memory_allocated()
        xl2f_launches = read_counts(fused_lp, fused_policy)
        xl2f_mean = xout["obj"].mean().item()
        xl2f_gap = (xl2f_mean - x_mean) / abs(x_mean)
        xl2f_inf = int((xout["infeasible"] > 0).sum())
        fixes = xout["n_fixed"].float()
        # the tail's iterations: from its start state (after compaction
        # and the rho fast-forward) to the end
        tail_it = (xout["iterations"] - tail_in.args[0].it
                   if tail_in.args is not None else None)
        log(f"  xl l2f: wall {xl2f_s:.2f} s (policy {xtm['policy_s']:.2f} s, "
            f"tail {xtm['tail_s']:.2f} s, {tail_it} tail iterations), "
            "routes policy "
            f"{xtm['policy_route']} tail {xtm['tail_route']}, buckets (n, m) "
            f"{xtm['buckets']}, it {xout['iterations']}, fixes/instance mean "
            f"{fixes.mean().item():.1f} min {fixes.min().item():.0f} max "
            f"{fixes.max().item():.0f}, launches {xl2f_launches}, peak "
            f"memory {peak_l2f / 2**30:.2f} GiB")
        log(f"  xl l2f mean obj {xl2f_mean:.2f} against the xl plain solve's "
            f"{x_mean:.2f}: gap {xl2f_gap:+.4%}; infeasible instances "
            f"{xl2f_inf}")
        require(xtm["policy_route"] == "windows",
                "xl l2f: the policy phase takes the windows route")
        require(xl2f_launches["K2"] > 0, f"xl l2f launched K2: {xl2f_launches}")
        require((xl2f_launches["K1"] > 0) == (xtm["tail_route"] == "k1"),
                f"xl l2f: K1 launched exactly on the K1 tail route: "
                f"{xl2f_launches}, {xtm['tail_route']}")
        xl_routes = {k: v for k, v in fused_lp.LAUNCHES.items() if v}
        log(f"  xl l2f K1 routes {xl_routes}, tail E route "
            f"{xtm['tail_e_route']}")
        if xtm["tail_route"] == "k1":
            require(xtm["tail_e_route"] == "int8-stream" and xl_routes == {
                "int8-stream": xl2f_launches["K1"]},
                f"xl l2f tail: every K1 launch int8-stream: {xl_routes}")
        require(xl2f_inf == 0, "xl l2f: 0 infeasible")
        require(finite(xout["obj"], xout["solution"]), "xl l2f: finite")
        require(xl2f_gap <= XL_L2F_GAP,
                f"xl l2f mean objective within {XL_L2F_GAP:.0%} of the xl "
                "plain solve's")
    summary.update(xl_l2f_s=xl2f_s, xl_l2f_timings=xtm,
                   xl_l2f_mean_obj=xl2f_mean, xl_l2f_gap=xl2f_gap,
                   xl_l2f_fixes=fixes.mean().item(),
                   xl_l2f_it=xout["iterations"], xl_l2f_tail_it=tail_it,
                   xl_l2f_peak_gib=peak_l2f / 2**30,
                   xl_l2f_launches=xl2f_launches)
    del xout

    # --- K2 and K1 at the xl l2f path's shapes, on its own operands -------
    with Phase("xl-l2f-check", 120) as ph:
        k2x_err = k2_check(fused_policy, packed, pop, k2_in.args[1], pcfg,
                           l2f)
        xrows = k2_in.args[1]
        k2x_ms = cuda_ms(lambda: fused_policy.policy_scores_cuda(
            packed, xrows, fused_policy.stride_of(pcfg), pop), 2)
        log(f"  K2 on the xl policy window's {xrows.shape[0]} rows: "
            f"{k2x_ms:.3f} ms a launch")
        summary["k2_xl_ms"] = k2x_ms
        tail_k1 = None
        if xtm["tail_route"] == "k1":
            tail_k1 = (*tail_in.args[:3], tail_in.kwargs.get("nfactor"))
            xl_cl = xl_tail_k1_check(*tail_k1, fused_lp, compare)
            k1_res["clusters at the xl tail"] = {"cases": xl_cl}
            require(tuple(xtm["k1_splits"][0][:2]) == xl_cl[0][:2],
                    f"xl tail: the path's first K1 launch {xtm['k1_splits']}"
                    f" took the plan checked here {xl_cl[0]}")
    summary["xl_l2f_check_s"] = ph.seconds
    del k2_in, tail_in

    # --- the very-large rung: K2's counts from 0 before the struct l2f
    # solve, read after it --------------------------------------------------
    with Phase("mega", 360) as ph:
        summary["mega"], mega_k2, mega_rows = mega_phase(
            workers["mega"], model, packed, pcfg, lp, fused_policy, l2f)
        k2m_err = k2_check(fused_policy, packed, pop, mega_rows, pcfg, l2f)
        summary["k2_mega_ms"] = cuda_ms(
            lambda: fused_policy.policy_scores_cuda(
                packed, mega_rows, fused_policy.stride_of(pcfg), pop), 2)
        log(f"  K2 on the mega policy window's {mega_rows.shape[0]} rows: "
            f"{summary['k2_mega_ms']:.3f} ms a launch")
        del mega_rows
        summary["mega_train"], mega_train_k2 = mega_train_check(fused_policy,
                                                                l2f)
    summary["mega_s"] = ph.seconds

    # --- the segmentation workload: K2's counts from 0 before each of its
    # l2f solves, read after each ---------------------------------------------
    with Phase("seg", SEG_BUDGET_S) as ph:
        summary["seg"], seg_k2, k2_seg = seg_phase(fused_policy, l2f)
    summary["seg_s"] = ph.seconds

    # --- the sparse attack: K2's counts from 0 before its l2f attack and
    # its search, read after each ------------------------------------------
    with Phase("attack", ATTACK_BUDGET_S) as ph:
        summary["attack"], attack_k2, k2_attack = attack_phase(fused_policy,
                                                               l2f)
    summary["attack_s"] = ph.seconds

    with Phase("timing", 120) as ph:
        kernels = timings(prob, cfg, pcfg, packed, pop, rows, lp, fused_lp,
                          fused_policy, launches, k1_res,
                          max(k2_err, k2x_err, k2m_err,
                              k2_seg["max_abs_err"],
                              k2_attack["max_abs_err"]))
        if tail_k1 is not None:
            summary["xl_tail_k1"] = xl_tail_k1_timing(*tail_k1, fused_lp)
            kernels[0]["routes_xl_tail"] = summary["xl_tail_k1"]["routes"]
        from lpbox_admm_tpu_torch.core.problem import LpProblem
        kernels[0]["clusters"] = summary["k1_split"] = k1_split_timing(
            fused_lp, lp, woodbury, LpProblem, cfg)
        # K1 on clusters against the plain version (k1_cluster_check)
        cl = [v for k_, v in k1_res.items() if k_.startswith("cluster-")]
        kernels[0]["cluster_checks"] = {
            "max_abs_err": max(v["max_abs_err_x"] for v in cl),
            "max_err_x_units": max(v["max_err_x_units"] for v in cl),
            "cases": {k_: v["cases"] for k_, v in k1_res.items()
                      if "cases" in v}}
        kernels[0]["launches_train"] = train_launches["K1"]
        kernels[1]["launches_train"] = train_launches["K2"]
        kernels[0]["launches_lp_options"] = auto_k1
        kernels[0]["launches_dp"] = [l_["plain"]["K1"] + l_["l2f"]["K1"]
                                     for l_ in dp_launches]
        kernels[1]["launches_dp"] = [l_["l2f"]["K2"] for l_ in dp_launches]
        kernels[1]["launches_mega"] = mega_k2
        kernels[1]["launches_mega_train"] = mega_train_k2
        kernels[1]["launches_seg"] = seg_k2
        kernels[1]["seg"] = k2_seg
        kernels[1]["launches_attack"] = attack_k2
        kernels[1]["attack"] = k2_attack
        kernels += xl_timings(k3_args, Gp, v4, s0x.ginv, fused_stream, symm,
                              {"K3": xl_launches["K3"],
                               "K4": sym_launches["K4"]}, k3_res, k4_res)
        kernels += probe_timings(probe_ops, probe_dot, probe_launches,
                                 probe_errs, ptxas)
    summary["timing_s"] = ph.seconds
    with Phase("train-split", 60) as ph:
        summary["train_split"] = train_split_fn()
        log(f"  where the train phase's time goes: "
            f"{summary['train_split']}")
    summary["total_s"] = time.perf_counter() - T_START
    log("summary " + json.dumps(summary, default=str))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


def timings(prob, cfg, pcfg, packed, pop, rows, lp, fused_lp, fused_policy,
            launches, k1_res, k2_err):
    """Kernel, plain-version times and bounds at the main path's shapes:
    K1 one 100-iteration m-side window of the 128-instance plain solve
    from its initial state; K2 one policy window of B*n = 65536 rows."""
    import torch
    B, m, n = prob.E.shape
    W = 100
    s0 = lp.init_state(prob, cfg)
    a = fused_lp.window_inputs(s0, prob, cfg)
    require(fused_lp.e_route(a.E) == "int8-resident",
            "timed K1 window on the main path's route")
    run_p = lambda: fused_lp.window_plain(a, cfg, 0, W, skip_cvg_at=0)
    # the main path's route, and the two streams of the streaming design
    k1_routes, k1_bytes_it = {}, {}
    for E_op in (a.E, prob.E, prob.E.to(torch.bfloat16)):
        ar = a._replace(E=E_op)
        route = fused_lp.e_route(E_op)
        run = lambda ar=ar: fused_lp.window_cuda(ar, cfg, 0, W, skip_cvg_at=0)
        out = run()
        require(int(out.done.sum()) == 0,
                "timed K1 window runs all iterations")
        k1_routes[route] = {"shape": [B, m, n], "ms": cuda_ms(run, 5)}
        k1_bytes_it[route] = k1_route_bytes(route, B, m, n, cfg, W)
    k1_ms = k1_routes["int8-resident"]["ms"]
    k1_plain_ms = cuda_ms(run_p, 2)
    k1_flops, k1_bytes = k1_work(a, out, cfg, 0, W)
    k1_bound = max(k1_flops / PEAK_F32_FLOPS, k1_bytes / PEAK_HBM_BYTES)

    R = rows.shape[0]
    run_k2 = lambda: fused_policy.policy_scores_cuda(packed, rows,
                                                     pcfg.chunk_dim, pop)
    run_p2 = lambda: fused_policy.policy_scores_plain(packed, rows,
                                                      pcfg.chunk_dim)
    k2_ms = cuda_ms(run_k2, 3)
    k2_plain_ms = cuda_ms(run_p2, 2)
    T, E = packed.peb.shape
    C = packed.w_top.shape[0]
    L = packed.wqkv.shape[0]
    F = packed.w1.shape[-1]
    k2_flops, k2_bytes, _ = k2_work(packed, rows)
    # f32 accuracy on the tensor cores takes three TF32 passes
    k2_bound = max(3 * k2_flops / PEAK_TF32_FLOPS,
                   k2_bytes / PEAK_HBM_BYTES)
    k2_l2 = k2_l2_bytes(R, T, C, L, F)
    k2_split = kernel_split(run_k2, ("policy_encoder_kernel",
                                     "policy_classifier_kernel"))
    from lpbox_admm_tpu_torch.scripts import tc_rate
    mma_rate = tc_rate.rate()
    log(f"  K1 window (B={B}, m={m}, n={n}, {W} its): {k1_ms:.3f} ms "
        f"int8-resident, plain {k1_plain_ms:.3f} ms, bound "
        f"{k1_bound * 1e3:.3f} ms ({k1_flops:.3e} flop, {k1_bytes:.3e} B); "
        "per route: " + ", ".join(
            f"{r} {v['ms']:.3f} ms, {k1_bytes_it[r]:.4g} B/it (closed form)"
            for r, v in k1_routes.items()))
    log(f"  K2 ({R} rows): {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms, "
        f"bound {k2_bound * 1e3:.3f} ms (3 TF32 passes of {k2_flops:.3e} "
        f"flop over {PEAK_TF32_FLOPS:.3g}; {k2_bytes:.3e} B; f32 on the "
        f"CUDA cores {k2_flops / PEAK_F32_FLOPS * 1e3:.3f} ms); weights "
        f"read from L2 {k2_l2['kernel']:.4g} B (closed form; 4-row blocks "
        f"each reading every weight: {k2_l2['four_row_blocks']:.4g} B); "
        f"per kernel (profiler) "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in k2_split.items())
        + "; the card's mma.sync m16n8k8 TF32 rate (scripts/tc_rate.py) "
        + ", ".join(f"{g} {v:.1f}" for g, v in mma_rate.items())
        + " TFLOP/s")
    return [
        {"name": "K1 lp_window", "route": "cuda",
         "source": "lpbox_admm_tpu_torch/csrc/lp_window.cuh",
         "replaces": "lpbox_admm_tpu/ops/pallas_lp.py:78",
         "launches": launches["K1"],
         # largest absolute error of the O(1) fields over every check
         "max_abs_err": max(r.get("max_abs_err_x", 0.0)
                            for r in k1_res.values()),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound * 1e3,
         "bound_by": "operations" if k1_flops / PEAK_F32_FLOPS
         >= k1_bytes / PEAK_HBM_BYTES else "bytes",
         "library_ms": None, "routes": k1_routes},
        {"name": "K2 policy_forward", "route": "cuda",
         "source": "lpbox_admm_tpu_torch/csrc/policy.cu",
         "replaces": "lpbox_admm_tpu/models/pallas_policy.py:152",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound * 1e3,
         "bound_by": "operations" if 3 * k2_flops / PEAK_TF32_FLOPS
         >= k2_bytes / PEAK_HBM_BYTES else "bytes",
         "library_ms": None},
    ]


def k2_l2_bytes(R, T, C, L, F, E=128):
    """Weight bytes K2 reads from L2 for R rows, in closed form: every
    encoder block (80 // T rows) streams each layer's dense weights
    (f32) and reads the small vectors once; every classifier block (64
    rows) reads wc0 and wc1 as TF32 hi|lo and its small vectors once.
    ``four_row_blocks``: the earlier f32 FMA design, every 4-row block
    reading all packed weights."""
    enc_blocks = -(-R // (80 // T))
    cls_blocks = -(-R // 64)
    enc = L * (4 * E * E + 2 * E * F + 5 * E + F) + (T + C) * E
    cls = 2 * (T * E * 256 + 256 * 128) + 256 + 128 + 128 * 16 + 16 + 16 + 1
    packed = (C * E + T * E + L * (4 * E * E + 2 * E * F + 5 * E + F)
              + T * E * 256 + 256 + 256 * 128 + 128 + 128 * 16 + 16 + 17)
    return {"kernel": 4.0 * (enc_blocks * enc + cls_blocks * cls),
            "four_row_blocks": 4.0 * -(-R // 4) * packed}


def kernel_split(fn, names, reps=2):
    """Device milliseconds per launch of each named kernel over ``reps``
    calls of ``fn`` (torch.profiler; an empty dict where it sees no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key and e.device_time_total > 0:
                total[name] = total.get(name, 0.0) + e.device_time_total
                count[name] = count.get(name, 0) + e.count
    return {k: total[k] / count[k] / 1e3 for k in total}


def k1_work(a, out, cfg, it0, W):
    """Flops and bytes of an m-side K1 window of W iterations from it0 in
    which no instance stops: each iteration does 5 (m x n) products (E^T
    w, E rhs, E x0, E^T u, E^T E x0), one (m x m) product and, every
    incumbent_stride-th iteration, one more (m x n) product (2 flops per
    FMA); each input read once, each output written once."""
    B, m, n = a.E.shape
    inc = len([t for t in range(it0, it0 + W)
               if t % cfg.incumbent_stride == 0])
    flops = B * 2.0 * (W * (5 * m * n + m * m) + inc * m * n)
    nbytes = sum(t.numel() * t.element_size() for t in (*a, *out)
                 if hasattr(t, "numel"))
    return flops, nbytes


def k1_route_bytes(route, B, m, n, cfg, W):
    """Bytes one m-side K1 iteration moves on a route, in closed form: a
    stream route reads E 3 times, once more every incumbent_stride-th
    iteration, at its bytes per entry, and G^{-1} (m x m f32) once; the
    resident route reads G^{-1} once and E once per W-iteration window."""
    fac = 4.0 * m * m
    if route == "int8-resident":
        return B * (fac + m * n / W)
    es = {"f32-stream": 4, "bf16-stream": 2, "int8-stream": 1}[route]
    return B * ((3 + 1.0 / max(cfg.incumbent_stride, 1)) * m * n * es + fac)


def random_01_lp(LpProblem, B, m, n, density, seed):
    """B random 0/1 LPs of shape (m, n) on the card (K1's split rows)."""
    import torch
    g = torch.Generator("cuda").manual_seed(seed)
    E = (torch.rand(B, m, n, device="cuda", generator=g) < density).float()
    ones = lambda *s: torch.ones(s, dtype=torch.bool, device="cuda")
    return LpProblem(b=-torch.rand(B, n, device="cuda", generator=g) * 100,
                     E=E, f=torch.ones(B, m, device="cuda"),
                     row_mask=ones(B, m), var_mask=ones(B, n))


def k1_split_timing(fused_lp, lp, woodbury, LpProblem, cfg):
    """K1 on clusters against one block an instance, at the l2f tails'
    shapes on random 0/1 LPs (CUDA events over 3 launches after a
    warm-up; a live instance runs the whole window):
    * the ca500 tail: (128, 256, 256), n side, int8-resident, 100
      iterations with 1 live instance (C = 8), 30 (C = 4; the factor's
      rows resident at both) and 55 (C = 2, the factor streamed);
    * the xl tail: (32, 1664, 2048), m side, int8-stream, 20 iterations
      with all 32 live: C = 2 (the rule on an H100, which holds 30
      clusters of 4 at one block an SM) and C = 4 (two waves).
    Per row: ms, iterations per ms and the bytes of the matrices a live
    instance's iteration reads (closed form, wherever they lie)."""
    import torch
    rows = []
    hw = fused_lp.card(torch.device("cuda"))
    for (B, m, n, nside, dens, W, cases) in (
            (128, 256, 256, True, 0.02, 100,
             [(1, 1), (1, 8), (30, 1), (30, 4), (55, 1), (55, 2)]),
            (32, 1664, 2048, False, 0.004, 20, [(32, 1), (32, 2), (32, 4)])):
        p = random_01_lp(LpProblem, B, m, n, dens, 19)
        s0 = lp.init_state(p, cfg)
        nf = None
        if nside:
            f = woodbury.factorize_nside(p.E, s0.free, lp._wb_ratio(cfg))
            nf = (f.hinv, f.ete)
        a = fused_lp.window_inputs(s0, p, cfg, nf)
        route = fused_lp.e_route(a.E)
        inc = 1.0 / cfg.incumbent_stride
        mat_bytes = (m * n * (2 + inc) + 8.0 * n * n) if nside else \
            (m * n * (3 + inc) + 4.0 * m * m)
        for live, C in cases:
            done = torch.arange(B, device="cuda") >= live
            ac = a._replace(done=done.to(torch.int32), cluster=C)
            run = lambda ac=ac: fused_lp.window_cuda(ac, cfg, 0, W, 0)
            out = run()
            require(int(out.done.sum()) == B - live,
                    f"K1 split timing: {live} live run the whole window")
            require(finite(out.x, out.z1, out.z4), "K1 split timing: finite")
            ms = cuda_ms(run, 3)
            plan = fused_lp.split_plan(live, m, n, nside, route, hw.sms,
                                       hw.max_active)
            rows.append({"shape": [B, m, n], "nside": nside, "route": route,
                         "live": live, "cluster": C, "plan": plan,
                         "fac_resident": fused_lp.factor_resident(
                             m, n, route, C, nside), "iters": W, "ms": ms,
                         "it_per_ms": W / ms,
                         "matrix_bytes_per_it": live * mat_bytes})
    log("  K1 on clusters (window_cuda, CUDA events): " + "; ".join(
        f"{r['shape']} {'n' if r['nside'] else 'm'} side {r['live']} live "
        f"C={r['cluster']}{' res' if r['fac_resident'] else ''} "
        f"(plan {r['plan']}): {r['ms']:.3f} ms, {r['it_per_ms']:.3f} it/ms, "
        f"{r['matrix_bytes_per_it']:.4g} B/it" for r in rows))
    return rows


def xl_tail_k1_timing(st, prob, cfg, nfactor, fused_lp, W=100):
    """K1 at the xl l2f tail's bucket: one W-iteration window from the
    state the path handed K1, CUDA events over 3 launches after a warm-up
    (the path's own windows are 1000 iterations long), on the path's
    route (int8-stream) and on the f32 stream of the streaming design.
    Instances that stop inside the window leave their block early, so
    the time is that of the slowest instance."""
    a = fused_lp.window_inputs(st, prob, cfg, nfactor)
    B, m, n = a.E.shape
    routes, bytes_it = {}, {}
    for E_op in (a.E, prob.E):
        ar = a._replace(E=E_op)
        route = fused_lp.e_route(E_op)
        run = lambda ar=ar: fused_lp.window_cuda(ar, cfg, st.it, W)
        out = run()
        ms = cuda_ms(run, 3)
        routes[route] = {"shape": [B, m, n], "ms": ms, "ms_per_it": ms / W}
        if nfactor is None:
            bytes_it[route] = k1_route_bytes(route, B, m, n, cfg, W)
    ms = routes[fused_lp.e_route(a.E)]["ms"]
    res = {"shape": [B, m, n], "nside": nfactor is not None, "it0": st.it,
           "iters": W, "route": fused_lp.e_route(a.E), "ms": ms,
           "ms_per_it": ms / W, "routes": routes,
           "done_before": int(st.done.sum()),
           "done_after": int(out.done.sum())}
    if nfactor is None:
        flops, nbytes = k1_work(a, out, cfg, st.it, W)
        res["bound_ms_if_none_stop"] = 1e3 * max(flops / PEAK_F32_FLOPS,
                                                 nbytes / PEAK_HBM_BYTES)
    log("  K1 at the xl tail bucket: " + json.dumps(res)
        + "; bytes per iteration (closed form, k1_route_bytes): "
        + json.dumps(bytes_it))
    return res


def xl_timings(args, Gp, v, ginv, fused_stream, symm, launches, k3_res,
               k4_res):
    """K3 and K4 at the xl block's shapes, L2 cold before each call: K3
    one sweep at (8, 1664, 4096) bf16; K4 one apply at (8, 1664) from the
    91 packed blocks, its library yardstick the dense (8, 1664, 1664)
    ``torch.bmm``."""
    import torch
    flush = torch.empty(256 * 2**20, dtype=torch.float32, device="cuda")
    E = args[0]
    B, m, n = E.shape
    k3_ms = cuda_ms_cold(lambda: fused_stream.sweep_cuda(*args), 20, flush)
    k3_plain_ms = cuda_ms_cold(lambda: fused_stream.sweep_plain(*args), 5,
                               flush)
    # each input read once, each output written once: E, M, 7 n-vectors,
    # s; V, F, the 16 sums.  Per column and instance 4 m FMAs for the
    # transpose products and 8 m for the forward ones.
    k3_bytes = E.numel() * E.element_size() + sum(
        t.numel() * 4 for t in args[1:10]) + 4 * B * (12 * n + 8 * m + 16)
    k3_flops = 24.0 * m * n * B
    k3_bound = max(k3_bytes / PEAK_HBM_BYTES, k3_flops / PEAK_F32_FLOPS)

    k4_ms = cuda_ms_cold(lambda: symm.symm_matvec_cuda(Gp, v), 50, flush)
    k4_plain_ms = cuda_ms_cold(lambda: symm.symm_matvec_plain(Gp, v), 10,
                               flush)
    k4_lib_ms = cuda_ms_cold(lambda: torch.bmm(ginv, v[..., None]), 50,
                             flush)
    L, T = Gp.shape[1], m // 128
    k4_bytes = Gp.numel() * 4 + 2 * v.numel() * 4
    k4_flops = 2.0 * B * 128 * 128 * (2 * (L - T) + T)
    k4_bound = max(k4_bytes / PEAK_HBM_BYTES, k4_flops / PEAK_F32_FLOPS)
    log(f"  K3 sweep (B={B}, m={m}, n={n}, bf16 E): {k3_ms:.4f} ms, plain "
        f"{k3_plain_ms:.4f} ms, bound {k3_bound * 1e3:.4f} ms "
        f"({k3_flops:.3e} flop, {k3_bytes:.3e} B)")
    log(f"  K4 symm apply (B={B}, m={m}, L={L}): {k4_ms:.4f} ms, plain "
        f"{k4_plain_ms:.4f} ms, dense bmm {k4_lib_ms:.4f} ms, bound "
        f"{k4_bound * 1e3:.4f} ms ({k4_flops:.3e} flop, {k4_bytes:.3e} B)")
    by = lambda fl, by_: "operations" if fl / PEAK_F32_FLOPS \
        >= by_ / PEAK_HBM_BYTES else "bytes"
    return [
        {"name": "K3 stream_sweep", "route": "cuda",
         "source": "lpbox_admm_tpu_torch/csrc/stream_sweep.cu",
         "replaces": "lpbox_admm_tpu/ops/pallas_stream.py:75",
         "launches": launches["K3"], "max_abs_err": k3_res["max_abs_err"],
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound * 1e3,
         "bound_by": by(k3_flops, k3_bytes), "library_ms": None},
        {"name": "K4 symm_matvec", "route": "cuda",
         "source": "lpbox_admm_tpu_torch/csrc/symm.cu",
         "replaces": "lpbox_admm_tpu/ops/pallas_symm.py:63",
         "launches": launches["K4"], "max_abs_err": k4_res["max_abs_err"],
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound * 1e3,
         "bound_by": by(k4_flops, k4_bytes), "library_ms": k4_lib_ms},
    ]


def host_us(fn, reps):
    """Microseconds of host time per call of ``fn``: ``time.perf_counter``
    around ``reps`` calls with no synchronize between them (the enqueue,
    not the device's work)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def probe_timings(ops, probe_dot, launches, errs, ptxas):
    """P1-P3 and the library yardstick ``torch.bmm(E, v[..., None])`` at
    each shape of ``ops``, two ways: one call at a time after a 1 GiB
    read that leaves L2 cold (the rows' ``ms`` at the probe's shape,
    ``ms_xl`` at PROBE_XL), and back to back (logged); the plain
    versions back to back and the host's enqueue time per call at the
    probe's shape; P1's registers from ptxas."""
    import torch
    flush = torch.empty(256 * 2**20, dtype=torch.float32, device="cuda")
    reps = {"probe": (50, 200), "xl": (20, 50)}
    res = {}
    for label, (E, v) in ops.items():
        bt, m, n = E.shape
        fns = {name: (lambda name=name: probe_dot.launch(name, E, v))
               for name in probe_dot.NAMES}
        fns["bmm"] = lambda: torch.bmm(E, v[..., None])
        cold = {k: cuda_ms_cold(f, reps[label][0], flush)
                for k, f in fns.items()}
        warm = {k: cuda_ms(f, reps[label][1]) for k, f in fns.items()}
        host = ({k: host_us(f, reps[label][1]) for k, f in fns.items()}
                if label == "probe" else {})
        # each input read once, the output written once
        nbytes = 4 * (E.numel() + v.numel() + bt * m)
        for i, name in enumerate(probe_dot.NAMES):
            if name == "pairs":
                # bt-fold products, three passes on the TF32 tensor cores
                flops = 2.0 * bt * bt * m * n
                t_ops = 3 * flops / PEAK_TF32_FLOPS
            else:
                flops = 2.0 * bt * m * n
                t_ops = flops / PEAK_F32_FLOPS
            t_bytes = nbytes / PEAK_HBM_BYTES
            bound = max(t_bytes, t_ops)
            log(f"  P{i + 1} {name} ({bt}, {m}, {n}), E {4 * E.numel()} B: "
                f"{cold[name]:.4f} ms L2 cold, {warm[name] * 1e3:.1f} us "
                f"back to back; bmm {cold['bmm']:.4f} ms cold, "
                f"{warm['bmm'] * 1e3:.1f} us back to back; bound "
                f"{bound * 1e3:.5f} ms ({flops:.3e} flop, {nbytes} B), "
                f"{bound * 1e3 / cold[name]:.1%} of it"
                + (f"; host {host[name]:.1f} us a call, bmm "
                   f"{host['bmm']:.1f}" if host else ""))
            res.setdefault(name, {})[label] = {
                "ms": cold[name], "library_ms": cold["bmm"],
                "bound_ms": bound * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "host_us": host.get(name), "library_host_us": host.get("bmm")}
    E, v = ops["probe"]
    rows = []
    replaces = {"batched_dot": 43, "pairs": 50, "vpu": 61}
    for i, name in enumerate(probe_dot.NAMES):
        plain = cuda_ms(lambda name=name: probe_dot.PLAIN[name](E, v), 50)
        p, x = res[name]["probe"], res[name]["xl"]
        rows.append(
            {"name": f"P{i + 1} probe {name}", "route": "cuda",
             "source": "lpbox_admm_tpu_torch/csrc/probe_dot.cu",
             "replaces": f"scripts/probe_dot.py:{replaces[name]}",
             "launches": launches[name], "max_abs_err": errs["probe"][name],
             "ms": p["ms"], "plain_ms": plain, "bound_ms": p["bound_ms"],
             "bound_by": p["bound_by"], "library_ms": p["library_ms"],
             "host_us": p["host_us"], "library_host_us": p["library_host_us"],
             "max_abs_err_xl": errs["xl"][name], "ms_xl": x["ms"],
             "bound_ms_xl": x["bound_ms"], "library_ms_xl": x["library_ms"]})
    rows[0]["registers"] = {k: r["registers"] for k, r in ptxas.items()
                            if k.startswith("P1 ")}
    return rows


if __name__ == "__main__":
    sys.exit(main())
