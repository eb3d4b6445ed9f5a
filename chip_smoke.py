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

The batched-matvec probe (``lpbox_admm_tpu_torch.scripts.probe_dot``,
the port of the JAX package's ``scripts/probe_dot.py``): its three
formulations P1-P3 at (8, 256, 256) through the entry point's own
functions; the kernels are also checked and timed at (8, 1664, 4096).

Then the large-rung path: the reference's xl CA instance (800 items x
4000 bids), 32 instances padded to (m, n) = (1664, 4096), solved by the
blocked single-stream solve (``core.lp.solve_blocked(stream=True)``,
bf16 E, blocks of 8, windows of 500, 9000 iterations) with K3 the sweep
and, on the packed-symmetric G^{-1} route, K4; and by
``l2f_solve_compact`` at the CA-500 operating point, whose policy phase
records with ``core.lp`` windows (K1 cannot hold that shape) and whose
tail runs in K1 when the compacted bucket fits it.

K1 takes CA's 0/1 E as an exact one-byte copy: resident in shared
memory at CA-500 (the ``int8-resident`` route of the plain and the l2f
solve), streamed at the xl l2f tail's bucket (``int8-stream``); each
K1 check launches the same window again on the f32-stream route (E as
stored) and requires the same bits in every output, and the main path's
routes are required.

Phases, cheapest first, each under its own deadline and a watchdog that
turns a hang into a traceback and a non-zero exit: device, build (one
nvcc process per source, started together; K1's and K3's registers and
spills from ptxas, K3 at the xl block without spills; K2's encoder and
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
solve's end state, the xl instances, K3 (with two planted faults) and K4 against their
plain versions on the first block of 8, the xl solve, a packed-symmetric
window, the xl l2f solve, K2 and K1 against their plain versions on the
operands the xl l2f solve gave them (its first policy window's 131 072
trajectory rows; the tail's start state in its compacted bucket, with a
planted fault), kernel timings (K1 also at that bucket; K2 at 65 536
rows split into its two kernels by the profiler, with its closed-form L2
weight bytes and the card's mma.sync TF32 rate from
``scripts/tc_rate.py``); the whole script under 600 s.
Fails on a build or launch error, a kernel/plain disagreement, a
planted fault that a kernel's limit does not catch, a repeat launch
that differs, a one-byte K1 route that differs from the f32 route in
one bit, a non-finite value, an infeasible instance, a kernel that its path did not
launch, a K1 launch of the main path on another route than its data
gives, an l2f mean objective gap above +2% against the plain solve, an
xl mean objective more than 10% worse than the JAX package's TPU record,
or an xl l2f mean objective more than 10% worse than the xl plain
solve's.  Prints one progress line per phase, a JSON ``kernels`` line,
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.

Needs a CUDA device: without one it exits non-zero at once.  It imports
only the port, torch, numpy and the standard library, and writes
nothing but the kernel build directory ``lpbox_admm_tpu_torch/_build``.
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
TOTAL_BUDGET_S = 600           # whole script, build included
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

T_START = time.perf_counter()


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
    """Registers and spill bytes of K1's, K2's and K3's instances, from
    the build's ``ptxas -v`` output (empty for a cached build)."""
    import re
    label = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}
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
            cur = (f"K3 sweep_kernel<{label[k3.group(1)]}, RPT={k3.group(2)}>"
                   if k3 else
                   f"K1 lp_window_kernel<{label[k1.group(1)]}, "
                   f"{'resident' if k1.group(2) == '1' else 'stream'}>"
                   if k1 else f"K2 {k2.group(1)}" if k2 else None)
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
    # incumbent stride 8 from the recorded window's end state
    c8 = cfg.replace(incumbent_stride=8)
    k8 = fused(k, tp, c8, 20)
    p8 = fused_lp.lp_window_plain(k, tp, c8, 20)
    compare("stride8-20it", k8, p8, c8)
    log(f"  K1 checks: routes {fused.routes}, each launch equal bit for "
        "bit to its f32-stream launch")
    return res, rows, compare


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
    ones."""
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


def main():
    faulthandler.enable()
    faulthandler.dump_traceback_later(TOTAL_BUDGET_S, exit=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
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
    fused_lp.LAUNCHES.update(dict.fromkeys(fused_lp.E_ROUTES, 0))
    fused_policy.LAUNCHES = 0
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

    with Phase("l2f-solve", 180) as ph:
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
        launches = {"K1": sum(fused_lp.LAUNCHES.values()),
                    "K2": fused_policy.LAUNCHES}
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
    summary["k1_done_check_s"] = ph.seconds

    # --- the large rung: the reference's xl instances --------------------
    from lpbox_admm_tpu_torch.ops import fused_stream, symm
    xcfg = LP_CONFIG.replace(linsolve="woodbury", matvec_dtype="bfloat16")
    with Phase("generate-xl", 240) as ph:
        rng = np.random.RandomState(XL_SEED)
        xinsts = [ca.generate_cauction(rng, n_items=XL_ITEMS, n_bids=XL_BIDS)
                  for _ in range(XL_BATCH)]
        xprob = ca.make_problem(xinsts, device="cuda")
        log(f"  {XL_BATCH} CA-({XL_ITEMS}, {XL_BIDS}) instances, E "
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
    fused_lp.LAUNCHES.update(dict.fromkeys(fused_lp.E_ROUTES, 0))
    fused_policy.LAUNCHES = 0
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
        xl2f_launches = {"K1": sum(fused_lp.LAUNCHES.values()),
                         "K2": fused_policy.LAUNCHES}
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
            xl_tail_k1_check(*tail_k1, fused_lp, compare)
    summary["xl_l2f_check_s"] = ph.seconds
    del k2_in, tail_in

    with Phase("timing", 120) as ph:
        kernels = timings(prob, cfg, pcfg, packed, pop, rows, lp, fused_lp,
                          fused_policy, launches, k1_res,
                          max(k2_err, k2x_err))
        if tail_k1 is not None:
            summary["xl_tail_k1"] = xl_tail_k1_timing(*tail_k1, fused_lp)
            kernels[0]["routes_xl_tail"] = summary["xl_tail_k1"]["routes"]
        kernels += xl_timings(k3_args, Gp, v4, s0x.ginv, fused_stream, symm,
                              {"K3": xl_launches["K3"],
                               "K4": sym_launches["K4"]}, k3_res, k4_res)
        kernels += probe_timings(probe_ops, probe_dot, probe_launches,
                                 probe_errs)
    summary["timing_s"] = ph.seconds
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
    fma_row = T * C * E + L * (T * E * 3 * E + 2 * T * T * E + T * E * E
                               + 2 * T * E * F) \
        + T * E * 256 + 256 * 128 + 128 * 16 + 16
    k2_flops = 2.0 * fma_row * R
    k2_bytes = rows.numel() * 4 + R * 4 + sum(
        t.numel() * 4 for t in packed)
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
         "source": "lpbox_admm_tpu_torch/csrc/lp_window.cu",
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
                 if t is not None)
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


def probe_timings(ops, probe_dot, launches, errs):
    """P1-P3 and the library yardstick ``torch.bmm(E, v[..., None])`` at
    each shape of ``ops``, two ways: one call at a time after a 1 GiB
    read that leaves L2 cold (the rows' ``ms`` at the probe's shape,
    ``ms_xl`` at PROBE_XL), and back to back (logged); the plain
    versions back to back at the probe's shape."""
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
                f"{bound * 1e3 / cold[name]:.1%} of it")
            res.setdefault(name, {})[label] = {
                "ms": cold[name], "library_ms": cold["bmm"],
                "bound_ms": bound * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
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
             "max_abs_err_xl": errs["xl"][name], "ms_xl": x["ms"],
             "bound_ms_xl": x["bound_ms"], "library_ms_xl": x["library_ms"]})
    return rows


if __name__ == "__main__":
    sys.exit(main())
