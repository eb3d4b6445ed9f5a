"""P1, the probe's batched-dot kernel, of several source trees in turns
on one card.

    python -m lpbox_admm_tpu_torch.scripts.probe_ab --tree parent=DIR \\
        [--tree NAME=DIR ...] [--shape BT,M,N ...] [--rounds 8] [--out FILE]

A tree is a directory holding ``lpbox_admm_tpu_torch/csrc/probe_dot.cu``
(a checkout, or an unpacked ``git archive`` of one); this checkout is
the tree ``this``.  Each tree's ``probe_dot.cu`` is compiled alone with
the package's nvcc flags (one ``nvcc`` each, all started together) into
``_build/``, loaded with ctypes, and its ``lpbox_probe_batched`` launched
on the same inputs.  At the probe's shape (8, 256, 256), the xl block
(8, 1664, 4096) and each ``--shape``:

* each tree's y against the float64 einsum (largest error over max
  |ref|), and whether the trees give the same bits;
* ``rounds`` rounds; in each, every tree and ``torch.bmm(E, v[..., None])``
  timed one after the other, the order reversed every other round, each
  as the mean of one call at a time after a 1 GiB read (L2 cold, CUDA
  events around the call); per tree the rounds' means, least, median and
  largest;
* the kernels' own time on the card per call, from ``torch.profiler``
  over as many cold calls (the launch excluded), by kernel name, where
  the profiler records device time;
* each tree's registers for P1's instances, from ptxas.

Prints one JSON object per shape and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import torch

from ..kernels import build
from . import probe_dot

SHAPES = {"probe": probe_dot.SHAPE, "xl": (8, 1664, 4096)}
REPS = {"probe": 50, "xl": 20}
#: cold calls per round at a ``--shape``
REPS_EXTRA = 50


def compile_trees(trees: Dict[str, Path]):
    """One ``nvcc`` per tree, all started together; returns the loaded
    libraries and each tree's registers per P1 instance."""
    nvcc = build.nvcc_path()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, root in trees.items():
        csrc = root / "lpbox_admm_tpu_torch" / "csrc"
        out = build.BUILD_DIR / f"probe_ab_{name}.so"
        cmd = [nvcc, *build.COMPILE_FLAGS, "-shared", "-I", str(csrc), "-o",
               str(out), str(csrc / "probe_dot.cu")]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs, regs = {}, {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for tree {name}:\n{err}")
        lib = ctypes.CDLL(str(out))
        for fn in (lib.lpbox_probe_batched,):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.lpbox_probe_args_size.restype = ctypes.c_int
        if lib.lpbox_probe_args_size() != ctypes.sizeof(probe_dot._Args):
            raise RuntimeError(f"tree {name}: ProbeArgs is "
                               f"{lib.lpbox_probe_args_size()} bytes")
        libs[name] = lib
        regs[name] = ptxas_registers(err)
    return libs, regs


def ptxas_registers(text: str) -> Dict[str, int]:
    """Registers of each ``probe_batched_kernel`` instance in ptxas's
    ``-v`` output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            cur = m.group(1) if "probe_batched_kernel" in m.group(1) else None
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = int(m.group(1))
    return out


def launcher(lib, E: torch.Tensor, v: torch.Tensor, y: torch.Tensor):
    """A call of the tree's P1 on E, v into y."""
    bt, m, n = E.shape
    args = probe_dot._Args(build.ptr(E), build.ptr(v), build.ptr(y), bt, m, n)

    def call():  # holds args, whose address the launcher reads
        code = lib.lpbox_probe_batched(
            ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"P1 launch: CUDA error {code}")
        return y
    return call


def cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean ms of one call with L2 cold (a 1 GiB read before each)."""
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


def kernel_us(fn, reps: int, flush: torch.Tensor, skip: str):
    """Device µs per call of each kernel ``fn`` launches, by name, with
    its launches per call, from torch.profiler over ``reps`` cold calls;
    the flush's own kernels (names holding ``skip``) are left out.
    Empty without device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t and skip not in e.key:
            out[e.key[:80]] = {"us": t / reps, "per_call": e.count / reps}
    return out


def spread(xs: List[float]) -> Dict[str, float]:
    return {"min": min(xs), "median": statistics.median(xs), "max": max(xs)}


def run_shape(label: str, shape, reps: int, libs, rounds: int,
              flush: torch.Tensor):
    bt, m, n = shape
    E_np, v_np = probe_dot.make_inputs(bt, m, n)
    E = torch.from_numpy(E_np).cuda()
    v = torch.from_numpy(v_np).cuda()
    want = torch.einsum("bmn,bn->bm", E.double(), v.double())
    scale = want.abs().max().item()
    fns, ys = {}, {}
    for name, lib in libs.items():
        y = torch.empty(bt, m, device="cuda")
        fns[name] = launcher(lib, E, v, y)
        ys[name] = fns[name]().clone()
    fns["bmm"] = lambda: torch.bmm(E, v[..., None])
    torch.cuda.synchronize()
    first = next(iter(ys.values()))
    res = {"shape": [bt, m, n], "rel_err": {
        k: (y.double() - want).abs().max().item() / scale
        for k, y in ys.items()},
        "same_bits": all(torch.equal(y, first) for y in ys.values())}
    order = list(fns)
    times = {k: [] for k in order}
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(cold_ms(fns[k], reps, flush))
    res["cold_ms"] = {k: {"rounds": t, **spread(t)} for k, t in times.items()}
    kernel_us(fns["bmm"], 2, flush, "reduce_kernel")  # the profiler's start
    res["kernel_us"] = {k: kernel_us(f, reps, flush, "reduce_kernel")
                        for k, f in fns.items()}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a directory holding "
                         "lpbox_admm_tpu_torch/csrc/probe_dot.cu")
    ap.add_argument("--shape", action="append", default=[],
                    help="BT,M,N, a shape timed beside the two")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = {"this": build.PKG_DIR.parent}
    for t in args.tree:
        name, _, d = t.partition("=")
        trees[name] = Path(d).resolve()
    libs, regs = compile_trees(trees)
    flush = torch.empty(256 * 2**20, dtype=torch.float32, device="cuda")
    out = {"device": torch.cuda.get_device_name(0), "registers": regs}
    print(json.dumps(out), flush=True)
    shapes = {k: (s, REPS[k]) for k, s in SHAPES.items()}
    for t in args.shape:
        s = tuple(int(x) for x in t.split(","))
        shapes["x".join(map(str, s))] = (s, REPS_EXTRA)
    for label, (shape, reps) in shapes.items():
        out[label] = run_shape(label, shape, reps, libs, args.rounds, flush)
        print(json.dumps({label: out[label]}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
