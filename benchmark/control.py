"""The readings the check's limits are set from, on the card:

    python3 -m benchmark.control --workload <cell> --seeds A,B,...
        [--seconds S] [--out FILE]

For each seed, in one process: a run of the cell with a short window
(at least the captured batch), the compared numbers of the program, and
the same numbers with the reference in TF32 put in the program's place
(the control, which must fail the limits).  With ``--fault NAME`` the
program runs with that fault planted (``faults.py``; the cell's kind
says which apply), and no control.  One JSON line a
seed on standard output (or in ``--out``).  The benchmark's own runs do
not run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import run as R
from .faults import NAMES, plant
from .manifest import Cell, kind


def readings(cell, seeds, seconds: float, device: str = "cuda",
             workers: int = 8, out=None, fault=None):
    """One row a seed: the program's numbers, and whether they pass the
    cell's limits; without a fault also the control's.  The first seed's
    row gives each window's numbers against the float32 reference too
    (``windows``)."""
    port = None
    if fault:
        port = R.load_port(device)
        plant(fault, port, kind(cell.config["instance"]["kind"]))
    rows = []
    for k, seed in enumerate(seeds):
        r = R.Run(cell, seed, seconds, False, device=device,
                  workers=workers, port=port)
        port = r.port
        ok, failed, nums, _ = R.judge(r, witness=k == 0)
        row = {"workload": cell.name, "fault": fault, "seed": seed,
               "batches": len(r.batches), "program": nums,
               "program_correct": ok}
        if not fault:
            c_ok, _, c_nums, _ = R.judge(r, control=True)
            row.update(control=c_nums, control_correct=c_ok)
        rows.append(row)
        if out is not None:
            print(json.dumps(row), file=out, flush=True)
        del r
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    ap.add_argument("--fault", choices=sorted(NAMES),
                    help="plant this fault under the timed path first")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(R.CACHE_DIR, exist_ok=True)
    cell = Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    f = open(args.out, "a") if args.out else sys.stdout
    try:
        readings(cell, seeds, args.seconds, out=f, fault=args.fault)
    finally:
        if args.out:
            f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
