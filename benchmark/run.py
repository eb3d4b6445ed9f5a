"""The benchmark of ``lpbox_admm_tpu_torch`` on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

One run: the cell's configuration and traffic mix by name
(``BENCHMARK.json``, ``configs/``, ``traffic/``), the program's kernels
loaded from the build cache in its checkout (built there on a first
run), the instance pool of the configuration's problem family (its kind
module, ``kinds/<instance.kind>.py``: made once by worker processes,
from the traffic's fixed pool seed, and then read from the pool cache
in the checkout; the run's seed draws or orders the batches), the
policy checkpoint where the traffic asks for one, a warm-up on the
cell's own shapes, then batches through the traffic's entry point
(``entries/``) in a closed loop for ``--seconds``: one client, each
batch started when the previous one has been answered and
synchronised.  Afterwards the reference judges what the window produced
(the kind's ``numbers`` and ``check.py``), and the last
line of standard output is the result: ``correct``, ``attempted``
(instances solved in the window), ``failed`` (answers that break the
configuration's guarantees: for auctions, selected solutions that are
infeasible or not finite), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones, read in a profiled
window), ``device``, ``breakdown`` (traced runs) and ``check`` (each
compared number with its limit).

Exits with 2 and prints no result without a card (or with fewer than
the cell asks for), with 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import sys
import time

from .capture import Recorder
from .manifest import Cell, entry, kind as find_kind, reader

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules the run may not load (compared whole: the port's
#: name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "lpbox_admm_tpu")
#: kernel and compiler caches, at fixed paths in the checkout
CACHE_DIR = os.path.join(ROOT, ".bench_cache")
#: generated instance pools, kept beside the kernel caches
POOL_DIR = os.path.join(CACHE_DIR, "pools")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def stream(seed: int, k: int):
    """An independent ``RandomState`` stream ``k`` of ``seed``."""
    import numpy as np
    return np.random.RandomState(
        np.random.SeedSequence([seed, 1000 + k]).generate_state(8))


def pool_params(cell) -> tuple:
    """(kind, its parameters, size) of the cell's pool: the
    configuration's instance kind and sizes, and the traffic's pool
    size."""
    inst = dict(cell.config["instance"])
    kind = inst.pop("kind")
    find_kind(kind)                     # an unknown kind stops the run here
    params = {k: v for k, v in inst.items() if k not in ("m_pad", "n_pad")}
    return kind, params, cell.traffic["pool"]


def pool_file(kind: str, params: dict, seed: int, size: int) -> str:
    """Where a generated pool is kept in the checkout: keyed by the
    kind, its parameters, the seed and the size."""
    key = "-".join([kind] + [f"{k}{v}" for k, v in sorted(params.items())]
                   + [f"seed{seed}", f"size{size}"])
    return os.path.join(POOL_DIR, key + ".npz")


class Pool:
    """The instance pool: loaded from the pool cache in the checkout, or
    made by worker processes and kept there (``start`` returns at once;
    ``result`` waits)."""

    def __init__(self, kind: str, params: dict, seed: int, size: int,
                 workers: int):
        self.t0 = time.perf_counter()
        self.path = pool_file(kind, params, seed, size)
        self.kind = find_kind(kind)
        self.make = functools.partial(self.kind.make, **params)
        self.args = ([seed] * size, list(range(size)))
        self.ex = None
        self.cached = os.path.exists(self.path)
        if not self.cached and workers > 1:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            self.ex = ProcessPoolExecutor(
                max_workers=min(workers, size),
                mp_context=multiprocessing.get_context("spawn"))
            self.fut = self.ex.map(self.make, *self.args)

    def result(self):
        try:
            if self.cached:
                try:
                    out = self.kind.load(self.path)
                except (OSError, ValueError, KeyError):
                    self.cached = False     # a damaged file: made anew
            if not self.cached:
                out = list(self.fut) if self.ex is not None else \
                    [self.make(*a) for a in zip(*self.args)]
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                tmp = self.path + ".part"
                self.kind.save(tmp, out)
                os.replace(tmp, self.path)
        finally:
            self.close()
        self.seconds = time.perf_counter() - self.t0
        return out

    def close(self):
        if self.ex is not None:
            self.ex.shutdown(wait=True, cancel_futures=True)
            self.ex = None


def start_pool(cell, seed: int, workers: int) -> Pool:
    """The pool of the traffic's fixed ``pool_seed`` (every seed then
    draws its batches from the same instances), or of ``seed``."""
    kind, params, size = pool_params(cell)
    return Pool(kind, params, cell.traffic.get("pool_seed", seed), size,
                workers)


def load_port(device: str) -> dict:
    """The program: its modules, and its kernels built or loaded from
    the build cache in the checkout."""
    import torch
    from lpbox_admm_tpu_torch.config import PolicyConfig, SolverConfig
    from lpbox_admm_tpu_torch.core import lp
    from lpbox_admm_tpu_torch.models import fused_policy
    from lpbox_admm_tpu_torch.ops import fused_lp
    from lpbox_admm_tpu_torch.train import l2f
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    t0 = time.perf_counter()
    if device == "cuda":
        from lpbox_admm_tpu_torch.kernels import build
        build.build()
        build.library()
    sync = (lambda: torch.cuda.synchronize()) if device == "cuda" \
        else (lambda: None)
    return dict(torch=torch, lp=lp, fused_lp=fused_lp,
                fused_policy=fused_policy, l2f=l2f,
                SolverConfig=SolverConfig, PolicyConfig=PolicyConfig,
                load_policy=load_policy, sync=sync,
                build_s=time.perf_counter() - t0)


def device_allocs(port) -> int:
    """How many times the caching allocator has asked CUDA for device
    memory so far (``cudaMalloc`` calls; 0 off the card)."""
    torch = port["torch"]
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    st = torch.cuda.memory_stats()
    return int(st.get("num_device_alloc", st.get("segment.all.allocated", 0)))


def _counts(port):
    return sum(port["fused_lp"].LAUNCHES.values()), \
        port["fused_policy"].LAUNCHES


class Run:
    """One run of a cell: set-up, window, and what the check needs."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", workers: int = 8, port=None,
                 pool=None):
        import numpy as np
        self.cell, self.seed, self.trace = cell, seed, trace
        cfg, tr = cell.config, cell.traffic
        self.kind = find_kind(cfg["instance"]["kind"])
        setup = {}
        t = time.perf_counter()
        if pool is None:
            pool = start_pool(cell, seed, workers)
        try:
            if port is None:
                port = load_port(device)
                setup["import_and_build_s"] = time.perf_counter() - t
            self.port = port
            torch = port["torch"]
            torch.backends.cuda.matmul.allow_tf32 = bool(cfg["allow_tf32"])
            torch.backends.cudnn.allow_tf32 = bool(cfg["allow_tf32"])
            scfg = port["SolverConfig"](**cfg["solver"])
            pcfg = port["PolicyConfig"](**cfg.get("policy", {}))
            t = time.perf_counter()
            model = None
            if tr.get("policy"):
                model = port["load_policy"](
                    os.path.join(ROOT, cfg["checkpoint"]), device=device)
            setup["checkpoint_s"] = time.perf_counter() - t
            t = time.perf_counter()
            self.instances = pool.result()
        finally:
            pool.close()
        setup["pool_wait_s"] = time.perf_counter() - t
        setup["pool_s"] = pool.seconds
        setup["pool_cached"] = pool.cached
        t = time.perf_counter()
        gather = self.kind.upload(port, self.instances, cfg["instance"],
                                  device)
        port["sync"]()
        setup["upload_s"] = time.perf_counter() - t
        solve = entry(tr["entry"])(port, dict(model=model, cfg=scfg,
                                              pcfg=pcfg, args=tr["args"]))
        B, P = tr["batch"], tr["pool"]

        order = stream(seed, 1).permutation(P)

        def draws(rng):
            """Batch after batch: the whole pool in the seed's order, or B
            of it drawn."""
            if tr["draw"] == "repeat":
                return lambda: order
            return lambda: np.sort(rng.choice(P, B, replace=False))

        whole = gather(order)

        def problem(idx):
            return whole if tr["draw"] == "repeat" else gather(idx)

        chk = tr["check"]
        pick = stream(seed, 2)
        self.captured_batch = int(pick.randint(0, chk["batch_of"]))
        rec = self.rec = Recorder(port, trace, self.kind, chk, pick)
        try:
            t = time.perf_counter()
            warm = draws(stream(seed, 3))
            for _ in range(tr["warmup_batches"]):
                solve(problem(warm()), False)
                port["sync"]()
            setup["warmup_s"] = time.perf_counter() - t
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            # what set-up made stays: the collector's later passes need not
            # walk it (they still run, inside the window, as for any user)
            gc.collect()
            gc.freeze()
            self.batches = []
            prof = None
            if trace:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if device == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
            self.setup_s = process_age_s()
            self._window(solve, problem, draws(stream(seed, 1)), seconds,
                         trace, port)
            if prof is not None:
                prof.stop()
        finally:
            rec.close()
        self.memory_peak = torch.cuda.max_memory_allocated() \
            if device == "cuda" else 0
        self.setup = setup
        self.trace_data = None
        if prof is not None:
            from . import trace as trace_mod, work
            self.trace_data = trace_mod.reduce(prof, work.KERNELS)
            del prof

    def _window(self, solve, problem, draw, seconds, trace, port):
        from torch.profiler import record_function
        sync = port["sync"]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        end = t0
        # the captured batch runs even where the window would end first
        while len(self.batches) <= self.captured_batch or \
                time.perf_counter() < deadline:
            k = len(self.batches)
            idx = draw()
            prob = problem(idx)
            self.rec.batch(k == self.captured_batch)
            c0 = _counts(port)
            a0, p0 = device_allocs(port), time.process_time()
            with record_function("bench.batch"):
                tb = time.perf_counter()
                res = solve(prob, trace)
                sync()
                end = time.perf_counter()
            c1 = _counts(port)
            res.update(idx=idx, n=len(idx), wall_s=end - tb,
                       cpu_s=time.process_time() - p0,
                       allocs=device_allocs(port) - a0,
                       k1=c1[0] - c0[0], k2=c1[1] - c0[1],
                       vars=sum(self.kind.variables(self.instances[i])
                                for i in idx))
            self.batches.append(res)
        self.rec.batch(False)
        self.window_s = end - t0


def work_totals(run: Run) -> dict:
    """Each kernel group's work over the window (``work.KERNELS``), from
    the recorded launches (traced runs): K2's here, the others' from the
    kind's capture; operations, bytes and the least time, each launch's
    the larger of its two bounds."""
    from . import work
    rec, pol = run.rec, run.cell.config.get("policy")
    launches = {name: [] for name in work.KERNELS}
    for name, ws in rec.kind.work().items():
        launches[name] += ws
    for rows, ws in rec.k2_rows:
        launches["k2"].append(work.k2_launch(
            rows, ws, pol["node_size"], pol["chunk_dim"], pol["embed_dim"],
            pol["n_layers"], pol["feed_forward_hidden"]))
    out = {}
    for name, ws in launches.items():
        least = [work.least_time(*w) for w in ws]
        out[name] = {"launches": len(ws),
                     "exact_flops": sum(w[0] for w in ws),
                     "dense_flops": sum(w[1] for w in ws),
                     "bytes": sum(w[2] for w in ws),
                     "least_s": sum(t for t, _ in least),
                     "bytes_bound_launches": sum(b == "bytes"
                                                 for _, b in least)}
    return out


def metrics(run: Run) -> dict:
    """The cell's metrics for this kind of run, each from its reader."""
    run.work = work_totals(run) if run.trace else None
    view = {"setup_s": run.setup_s, "window_s": run.window_s,
            "batches": run.batches, "trace": run.trace_data,
            "work": run.work}
    out = {}
    for m in (run.cell.per_layer if run.trace else run.cell.end_to_end):
        v = reader(m["name"])(view)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(run: Run, control: bool = False, witness: bool = False):
    """(correct, failed, numbers, rows) of the run's check."""
    from . import check
    torch = run.port["torch"]
    cfg = run.cell.config
    dev = run.batches[0]["sol"].device
    pool = run.kind.RefPool(run.instances, cfg["instance"], dev)
    captured = run.batches[min(run.captured_batch, len(run.batches) - 1)]
    ckpt = os.path.join(ROOT, cfg["checkpoint"]) \
        if cfg.get("checkpoint") else None
    with torch.no_grad():
        nums = run.kind.numbers(pool, run.batches, captured, run.rec, cfg,
                                ckpt, control=control, witness=witness)
    ok, rows = check.judge(nums, run.cell.limits["numbers"])
    return ok, nums["infeasible"], nums, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")
    # where set-up goes before ``Run``: the process's age at each step
    ages = {"age_at_main_s": process_age_s()}
    os.makedirs(CACHE_DIR, exist_ok=True)
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE_DIR, "nv")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    cell = Cell(args.workload)
    # the pool's workers start first: they make the instances while this
    # process imports the program and reaches the card
    pool = start_pool(cell, args.seed, min(8, os.cpu_count() or 1))
    try:
        import torch
        ages["age_after_torch_s"] = process_age_s()
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA "
                  f"device(s); torch.cuda.is_available() = "
                  f"{torch.cuda.is_available()}, device_count = "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        torch.set_num_threads(1)
        ages["age_after_card_check_s"] = process_age_s()
        run = Run(cell, args.seed, args.seconds, bool(args.trace),
                  device="cuda", pool=pool)
    finally:
        pool.close()
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    mets = metrics(run)
    try:
        ok, failed, nums, rows = judge(run)
    except Exception:                   # a check that cannot read fails
        import traceback
        traceback.print_exc()
        ok, failed, nums = False, int(sum(b["n"] for b in run.batches)), {}
        rows = [(n, None, lim) for n, lim in cell.limits["numbers"].items()]
    result = {"correct": bool(ok),
              "attempted": int(sum(b["n"] for b in run.batches)),
              "failed": int(failed), "metrics": mets,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips,
                         "memory_peak_bytes": int(run.memory_peak)}}
    if run.trace_data is not None:
        td = run.trace_data
        result["device"].update(busy_s=td["busy_s"], window_s=td["window_s"])
        result["breakdown"] = {"device_ops": td["device_ops"],
                               "idle_gaps": td["idle_gaps"]}
        result["work"] = dict(run.work, kernel_s=td["kernel_s"])
    result["setup"] = dict(ages, **run.setup, setup_s=run.setup_s,
                           batches=len(run.batches),
                           captured_batch=run.captured_batch)
    result["per_batch"] = {
        "ms": [1e3 * b["wall_s"] for b in run.batches],
        "cpu_ms": [1e3 * b["cpu_s"] for b in run.batches],
        "device_allocs": [b["allocs"] for b in run.batches],
        "iterations": [b.get("iterations") for b in run.batches]}
    result["numbers"] = {k: v for k, v in nums.items()
                         if k not in run.cell.limits["numbers"]}
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    for n, v, lim in rows:
        print(f"check {n} {v} limit {lim} "
              f"{'ok' if v is not None and v <= lim else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
