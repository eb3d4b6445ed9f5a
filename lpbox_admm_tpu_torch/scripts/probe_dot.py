"""Probe: three formulations of the batched matvec y[b] = E[b] v[b] as
hand-written CUDA kernels (``csrc/probe_dot.cu``) beside their plain
PyTorch versions.

Port of the JAX package's ``scripts/probe_dot.py``, which probed which
batched-matvec formulations lower in Mosaic (TPU Pallas) and which is
fastest per call:

* ``batched_dot`` (P1): one batched dot, on a persistent grid whose warps
  each stream a contiguous range of E's rows through a TMA ring in
  shared memory (any shape: no limit on n or bt);
* ``pairs`` (P2): one 2-D product of all bt*m rows of E against all bt
  vectors, (bt*m, n) @ (n, bt) -> (bt, m, bt), then the diagonal b = b'
  selected and summed: bt times P1's flops, as the TPU probe measured;
  the kernel runs the product on the tensor cores in three TF32 passes
  (hi*hi + hi*lo + lo*hi of each operand's split a = hi + lo);
* ``vpu`` (P3): a broadcast multiply E * v[:, None, :] and a row sum,
  each product rounded on its own.

    python -m lpbox_admm_tpu_torch.scripts.probe_dot [--device cpu]

builds E (8, 256, 256) and v (8, 256) f32 from ``RandomState(0)`` as the
JAX script does, runs each formulation, prints ``name: OK maxerr=...``
against the float64 ``einsum`` (``FAIL`` and exit status 1 above
``TOL`` of max |ref|) and, on the card, ``name: ... us/call`` from CUDA
events over back-to-back calls.  Each formulation launches its kernel on
CUDA tensors (counted in ``LAUNCHES``) and runs its plain version on CPU
tensors; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.problem import as_device

#: a result against the float64 einsum, relative to max |ref|: f32 sums
#: of n products in another order
TOL = 1e-5
#: limits of the kernels, each a copy of the constant of csrc/probe_dot.cu
#: named beside it, whose launchers refuse the same shapes; here they
#: refuse them before any launch, and on the CPU too.  P1 takes any shape.
P2_BTMAX = 64        # P2_BTMAX: P2 keeps 8 n-tiles of 8 vectors
GRID_Y_MAX = 65535   # P3 puts the instance on grid.y
#: the probe's shape, as the JAX script has it, and its timed calls
SHAPE = (8, 256, 256)
REPS = 200

NAMES = ("batched_dot", "pairs", "vpu")
_SYMBOL = {"batched_dot": "lpbox_probe_batched", "pairs": "lpbox_probe_pairs",
           "vpu": "lpbox_probe_vpu"}

#: kernel launches per formulation in this process
LAUNCHES: Dict[str, int] = dict.fromkeys(NAMES, 0)


def batched_dot_plain(E: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bmn,bn->bm", E, v)


def pairs_plain(E: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    bt, m, n = E.shape
    P = (E.reshape(bt * m, n) @ v.T).reshape(bt, m, bt)
    idx = torch.arange(bt, device=E.device)
    sel = idx[:, None, None] == idx[None, None, :]        # (bt, 1, bt)
    return torch.where(sel, P, torch.zeros_like(P)).sum(-1)


def vpu_plain(E: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (E * v[:, None, :]).sum(-1)


PLAIN: Dict[str, Callable] = {"batched_dot": batched_dot_plain,
                              "pairs": pairs_plain, "vpu": vpu_plain}


class _Args(ctypes.Structure):
    """ctypes mirror of ``ProbeArgs`` in csrc/probe_dot.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in ("E", "v", "y")] + [
        (name, ctypes.c_int) for name in ("bt", "m", "n")]


def check_shapes(name: str, E: torch.Tensor, v: torch.Tensor) -> None:
    """Refuse, before any launch, operands the kernel ``name`` does not
    take."""
    if name not in NAMES:
        raise ValueError(f"unknown formulation {name!r}")
    if E.dim() != 3 or v.dim() != 2 or tuple(v.shape) != (E.shape[0],
                                                          E.shape[2]):
        raise ValueError(f"{name}: expected E (bt, m, n) and v (bt, n), got "
                         f"{tuple(E.shape)} and {tuple(v.shape)}")
    bt, m, n = E.shape
    if min(bt, m, n) < 1:
        raise ValueError(f"{name}: empty shape {(bt, m, n)}")
    if name == "pairs" and bt > P2_BTMAX:
        raise ValueError(f"pairs: bt = {bt} is over {P2_BTMAX}")
    if name == "vpu" and bt > GRID_Y_MAX:
        raise ValueError(f"vpu: bt = {bt} is over {GRID_Y_MAX}")


def launch(name: str, E: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel ``name`` on PyTorch's current stream."""
    from ..kernels import build

    check_shapes(name, E, v)
    for label, t in (("E", E), ("v", v)):
        if not t.is_cuda or t.device != E.device:
            raise ValueError(f"{name}: {label} must be on the CUDA device of "
                             f"E, got device {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous float32, "
                             f"got {t.dtype}")
    if E.data_ptr() % 16:
        raise ValueError(f"{name}: E must be 16-byte aligned")
    bt, m, n = E.shape
    y = torch.empty((bt, m), dtype=torch.float32, device=E.device)
    p = build.ptr
    args = _Args(p(E), p(v), p(y), bt, m, n)
    lib = build.library()
    build.check_struct(lib, "lpbox_probe_args_size", _Args)
    stream = torch.cuda.current_stream(E.device).cuda_stream
    build.check(lib, getattr(lib, _SYMBOL[name])(ctypes.addressof(args),
                                                  stream), f"{name} kernel")
    LAUNCHES[name] += 1
    return y


def matvec(name: str, E: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = E v by the formulation ``name``: its kernel on a CUDA tensor
    (``launch`` checks the operands), its plain version on a CPU
    tensor."""
    if E.is_cuda:
        return launch(name, E, v)
    check_shapes(name, E, v)
    if E.device.type == "cpu":
        return PLAIN[name](E, v)
    raise ValueError(f"no {name} for device {E.device}")


def make_inputs(bt: int = 8, m: int = 256, n: int = 256, seed: int = 0):
    """E (bt, m, n) and v (bt, n) float32 numpy arrays, drawn as the JAX
    script draws them: ``rand`` for E, then for v."""
    rng = np.random.RandomState(seed)
    E = rng.rand(bt, m, n).astype(np.float32)
    v = rng.rand(bt, n).astype(np.float32)
    return E, v


def cuda_us(fn: Callable[[], object], reps: int) -> float:
    """Microseconds per call of ``fn`` on the card: CUDA events around
    ``reps`` back-to-back calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) * 1e3 / reps


def probe(device="cuda", out: Optional[Callable[[str], None]] = print
          ) -> Dict[str, dict]:
    """Run and check each formulation at ``SHAPE`` on ``device``; on the
    card also time it over ``REPS`` calls.  Returns per name ``maxerr``
    (absolute, against the float64 einsum), ``scale`` (max |ref|), ``ok``
    and ``us_per_call`` (None off the card)."""
    dev = as_device(device)
    E_np, v_np = make_inputs(*SHAPE)
    want = np.einsum("bmn,bn->bm", E_np.astype(np.float64),
                     v_np.astype(np.float64))
    scale = float(np.abs(want).max())
    E = torch.from_numpy(E_np).to(dev)
    v = torch.from_numpy(v_np).to(dev)
    res = {}
    for name in NAMES:
        y = matvec(name, E, v)
        err = float(np.abs(y.double().cpu().numpy() - want).max())
        ok = err <= TOL * scale
        us = cuda_us(lambda: matvec(name, E, v), REPS) if dev.type == "cuda" \
            else None
        res[name] = {"maxerr": err, "scale": scale, "ok": ok,
                     "us_per_call": us}
        if out is not None:
            out(f"{name}: {'OK' if ok else 'FAIL'} maxerr={err:.2e}")
    if out is not None and dev.type == "cuda":
        for name in NAMES:
            out(f"{name}: {res[name]['us_per_call']:.1f} us/call")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lpbox_admm_tpu_torch.scripts.probe_dot",
        description="Batched-matvec formulations P1-P3 against the einsum.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the plain "
                         "versions)")
    dev = as_device(ap.parse_args(argv).device)
    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""), flush=True)
    res = probe(dev, out=lambda s: print(s, flush=True))
    return 0 if all(r["ok"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
