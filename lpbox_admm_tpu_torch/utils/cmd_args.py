"""Shared command-line flags (the port of the JAX package's
``utils/cmd_args.py``; reference ``common/cmd_args.py:5-83`` and the
presets of ``experiments/01_run_train.sh`` / ``02_run_test.sh``).

The same flags with the same defaults, plus ``-device`` (``cuda``
unless the caller asks for ``cpu``).  ``-mesh N`` runs the CA driver
(``experiments/run_lp``) in N data-parallel ranks (``parallel.mesh``);
``check_ported`` refuses it, with a ``ValueError`` naming it, for the
drivers that do not shard their workload (``run_seg``, ``run_attack``:
the JAX package's drivers of those workloads ignore the flag).
"""

from __future__ import annotations

import argparse


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    # reference flags (common/cmd_args.py)
    p.add_argument("-phase", default="train",
                   choices=["train", "test", "generate", "solve"],
                   help="pipeline phase (cmd_args.py:13)")
    p.add_argument("-net", default="mha", choices=["mha", "mlp"],
                   help="policy network (cmd_args.py:27)")
    p.add_argument("-ws", type=int, default=100,
                   help="window size (cmd_args.py:28; 100 LP / 10 Seg / "
                        "50 attack)")
    p.add_argument("-col", type=int, default=500,
                   help="variable count (cmd_args.py:29)")
    p.add_argument("-num_epochs", type=int, default=20,
                   help="training epochs (cmd_args.py:25)")
    p.add_argument("-start_epoch", type=int, default=0)
    p.add_argument("-seed", type=int, default=19260817,
                   help="rng seed (cmd_args.py:11)")
    p.add_argument("-save_dir", default="saved_model",
                   help="checkpoint/log root")
    p.add_argument("-checkpoint", default=None,
                   help="checkpoint path to load for -phase test")
    # the JAX package's additions
    p.add_argument("-batch", type=int, default=8,
                   help="instance batch size per step")
    p.add_argument("-linsolve", default="woodbury",
                   choices=["cg", "woodbury"])
    p.add_argument("-matvec_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="constraint-matrix storage in the solve loop "
                        "(SolverConfig.matvec_dtype)")
    p.add_argument("-data_dir", default="data",
                   help="instance/trajectory data root")
    p.add_argument("-mesh", type=int, default=0,
                   help="data-parallel mesh size (0 = single device; N: "
                        "N ranks, one a card, gloo processes with "
                        "-device cpu; run_lp only)")
    p.add_argument("-damage_gate", type=float, default=0.0,
                   help="risk-calibrated fixing: shrink the confidence "
                        "margin with the variable's |b| rank "
                        "(PolicyConfig.damage_gate; 0 = global "
                        "threshold)")
    p.add_argument("-boundary_gate", type=float, default=0.0,
                   help="seg-only risk calibration: scale the fix "
                        "margin by (1-gate) for pixels within "
                        "-boundary_band hops of the current label "
                        "boundary (PolicyConfig.boundary_gate; 1 = never "
                        "fix inside the band)")
    p.add_argument("-boundary_band", type=int, default=2,
                   help="8-neighbour radius of the protected boundary "
                        "band (PolicyConfig.boundary_band)")
    # the port's addition
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="where tensors live: the card unless asked for "
                        "the CPU")
    return p


def check_ported(args: argparse.Namespace,
                 data_parallel: bool = True) -> None:
    """Refuse the settings the calling driver does not implement:
    ``-mesh > 0`` where the driver does not shard its workload
    (``data_parallel=False``)."""
    if not data_parallel and getattr(args, "mesh", 0) > 0:
        raise ValueError(f"-mesh {args.mesh}: this driver does not shard "
                         "its workload over devices (data parallelism runs "
                         "in experiments.run_lp only); run with -mesh 0")
