"""Image-segmentation experiment entry point (the port of the JAX
package's ``experiments/run_seg.py``; reference Segmentation silo):

* ``-phase solve`` ~ cython/src/image_segmentation.cpp main (:15-31):
  plain batched solves of the images at about ``-num_nodes`` pixels,
  recorded trajectory CSVs, the xiter_all.csv oracle and output PNGs;
* ``-phase train`` ~ Segmentation/experiments/run.py -phase train:
  imitation training on 5 episodes of ws = 10 sliding windows, with the
  in-loop l2f validation and checkpoints;
* ``-phase test``  ~ run.py -phase test -> _my_valid (trainer.py:
  676-811): the l2f solve against the plain oracle, energy gap, pixel
  agreement and PNG outputs.

    python -m lpbox_admm_tpu_torch.experiments.run_seg -phase solve -n 8 -num_nodes 10000 -image_dir DIR
    python -m lpbox_admm_tpu_torch.experiments.run_seg -phase train -net mha -ws 10 -image_dir DIR
    python -m lpbox_admm_tpu_torch.experiments.run_seg -phase test -net mha -ws 10 -image_dir DIR

Everything runs on the card unless ``-device cpu`` is given.  Reading
and writing PNGs needs PIL; ``.npy`` intensity arrays load without it.
``-phase test`` runs ``train.l2f.l2f_solve_seg``: the compacting l2f
(``l2f_solve_compact_qp``) on every device unless ``-compact 0`` asks
for the masked one (``l2f_solve``), then selection and the descents
(the reported wall includes them).  The JAX package's ``-compact -1``
compacts on the CPU only, because the TPU's gathers serialize; on the
card the compacting solve's best wall was at most the masked one's at
1e4 px x 8 and 1e5 px x 8 images, at the same quality (chip_smoke's seg
phase, PERF.md section 5).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Sequence

from ..utils.cmd_args import base_parser, check_ported

def parse_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("Segmentation BQP with learned early fixing")
    p.set_defaults(ws=10)
    p.add_argument("-n", type=int, default=8, help="number of images")
    p.add_argument("-n_eval", type=int, default=2)
    p.add_argument("-num_nodes", type=int, default=10_000,
                   help="target pixel count (1e4 standard, 1e5 "
                        "generalization)")
    p.add_argument("-image_dir", default=None,
                   help="defaults to the reference's shipped images "
                        "(adapters.segmentation.reference_image_paths)")
    p.add_argument("-image_list", default=None,
                   help="comma-separated image ids (e.g. the "
                        "generalization list of Seg trainer.py:832); "
                        "overrides -n/-n_eval slicing for the eval set")
    p.add_argument("-result_dir", default="result")
    p.add_argument("-max_eval_iters", type=int, default=30,
                   help="l2f iteration budget (Seg trainer.py:705)")
    p.add_argument("-repair_sweeps", type=int, default=8,
                   help="ICM one-flip polish sweeps applied to BOTH the "
                        "plain oracle and the l2f solution in -phase "
                        "test (0 = reference reporting semantics)")
    p.add_argument("-pair_sweeps", type=int, default=4,
                   help="domino (two-pixel) flip descent sweeps after "
                        "the ICM polish, both sides (0 = off)")
    p.add_argument("-compact", type=int, default=-1,
                   help="physically compact the l2f residual problem "
                        "between windows in -phase test (the reference's "
                        "Ma/Mb shrink; 0 = masked full-grid iteration; "
                        "-1, the JAX package's auto, compacts on every "
                        "device: the card measured no worse)")
    p.add_argument("-refine_rounds", type=int, default=1,
                   help="repeat the re-free + iterate cycle on the "
                        "moved boundary this many times")
    p.add_argument("-refine_band", type=int, default=1,
                   help="8-neighbour radius of the re-freed band")
    p.add_argument("-init_checkpoint", default=None,
                   help="warm-start -phase train from this policy "
                        "checkpoint (fine-tune; pair with a low -lr)")
    p.add_argument("-train_image_list", default=None,
                   help="explicit image ids for the -phase train set")
    p.add_argument("-lr", type=float, default=None,
                   help="override PolicyConfig.lr (fine-tune)")
    p.add_argument("-eval_semantics", default="raw", choices=["raw", "full"],
                   help="in-loop -phase train validation scoring: 'full' "
                        "applies the test protocol's repair + pair polish "
                        "to both sides")
    p.add_argument("-refine_iters", type=int, default=0,
                   help="post-fix refinement: re-free boundary-band fixed "
                        "pixels and run this many extra ADMM iterations "
                        "before rounding (l2f side only)")
    p.add_argument("-traj_fix_thr", type=float, default=0.0,
                   help="trajectory-extremity fixing: also fix pixels with "
                        "|x-0.5| > thr to round(x) at each fix event "
                        "(PolicyConfig.traj_fix_thr; masked l2f only)")
    p.add_argument("-traj_fix_only", type=int, default=0,
                   help="1 = ignore the net's sigmoid entirely (pure "
                        "trajectory fixing)")
    args = p.parse_args(argv)
    check_ported(args, data_parallel=False)
    return args


def _ids(spec: str):
    return [int(v) for v in spec.split(",")]


def main(argv: Optional[Sequence[str]] = None, log=print):
    """Run one phase; returns what it made (the plain dataset, the
    trained state or the test metrics)."""
    args = parse_args(argv)
    if args.save_dir == "saved_model":
        args.save_dir = os.path.join("saved_model", "seg", args.net)
    from ..adapters import segmentation as seg
    from ..config import SEG_CONFIG, PolicyConfig
    from ..models.policy import build_policy
    from ..train import imitation, l2f
    from ..utils import io as uio
    from ..utils.profiling import sync

    cfg = SEG_CONFIG
    pcfg = PolicyConfig(net=args.net, node_size=5, chunk_dim=5,
                        window_mode="sliding", damage_gate=args.damage_gate,
                        boundary_gate=args.boundary_gate,
                        boundary_band=args.boundary_band,
                        traj_fix_thr=args.traj_fix_thr,
                        traj_fix_only=bool(args.traj_fix_only))
    if args.lr is not None:
        pcfg = pcfg.replace(lr=args.lr)
    if args.image_dir:
        all_paths = [os.path.join(args.image_dir, p)
                     for p in sorted(os.listdir(args.image_dir))]
    else:
        all_paths = seg.reference_image_paths()
    paths = all_paths[:args.n]
    by_id = {os.path.splitext(os.path.basename(p))[0]: p for p in all_paths}
    load = lambda ps: seg.load_problem(ps, num_nodes=args.num_nodes,
                                       device=args.device)
    os.makedirs(args.result_dir, exist_ok=True)

    if args.phase == "solve":
        prob = load(paths)
        t0 = time.perf_counter()
        ds = imitation.build_dataset_qp(prob, cfg, record_iters=5 * args.ws)
        wall = time.perf_counter() - t0
        H, W = prob.grid
        traj = ds.traj.cpu().numpy()
        labels = ds.labels.cpu().numpy()
        energy = ds.oracle_obj.cpu().numpy()
        mask = prob.mask.cpu().numpy()
        xall = os.path.join(args.result_dir, "xiter_all.csv")
        for i, p in enumerate(paths):
            name = os.path.splitext(os.path.basename(p))[0]
            uio.write_xiter_csv(os.path.join(args.result_dir, f"{name}.csv"),
                                traj[i])
            uio.append_allres(xall, int(name) if name.isdigit() else i,
                              -float(energy[i]), ds.oracle_iters,
                              wall / len(paths))
            seg.save_img(labels[i].reshape(H, W), mask[i],
                         os.path.join(args.result_dir, f"output_{name}.png"))
        log(f"solved {len(paths)} images in {wall:.1f}s "
            f"({ds.oracle_iters} iters); mean energy {energy.mean():.1f}")
        return ds

    model = build_policy(args.net, pcfg.node_size, pcfg.chunk_dim,
                         pcfg.pe_dim)
    trainer = imitation.PolicyTrainer(model, pcfg, cfg, ws=args.ws,
                                      save_dir=args.save_dir,
                                      device=args.device)
    n_train = args.n - args.n_eval
    eval_paths = paths[n_train:]
    if args.image_list:
        # the reference's hand-picked generalization images
        # (_my_valid_2 my_list, Seg trainer.py:832)
        eval_paths = [by_id[str(i)] for i in _ids(args.image_list)]
    eval_prob = load(eval_paths)
    full_val = args.phase == "test" or args.eval_semantics == "full"
    val_rep = args.repair_sweeps if full_val else 0
    val_pair = args.pair_sweeps if full_val else 0
    eval_ds = imitation.build_dataset_qp(eval_prob, cfg,
                                         record_iters=5 * args.ws,
                                         repair_sweeps=val_rep,
                                         pair_sweeps=val_pair)
    H, W = eval_prob.grid
    eval_labels = eval_ds.labels.reshape(eval_prob.batch, H, W)

    if args.phase == "train":
        train_paths = paths[:n_train]
        if args.train_image_list:
            train_paths = [by_id[str(i)] for i in _ids(args.train_image_list)]
        train_ds = imitation.build_dataset_qp(load(train_paths), cfg,
                                              record_iters=5 * args.ws)
        ts = (trainer.load(args.init_checkpoint) if args.init_checkpoint
              else trainer.init(args.seed))

        def score(ts_):
            # validation as -eval_semantics says: "full" runs the test
            # protocol (refinement + both-sides polish)
            state = l2f.l2f_solve(eval_prob, trainer.variables(ts_), cfg,
                                  pcfg, ws=args.ws,
                                  max_iter=args.max_eval_iters)
            if full_val and args.refine_iters > 0:
                state = l2f.qp_refine_boundary(
                    state, eval_prob, cfg, iters=args.refine_iters,
                    rounds=args.refine_rounds, band=args.refine_band)
            m = l2f.l2f_metrics_qp(state, eval_prob, eval_ds.oracle_obj,
                                   eval_labels, repair_sweeps=val_rep,
                                   pair_sweeps=val_pair)
            return (float(m["energy_gap"].mean()),
                    float(m["n_fixed"].float().mean()))

        best = None
        history = []
        if args.init_checkpoint:
            # fine-tune floor: the kept best is never worse than the start
            best, nfix = score(ts)
            log(f"init: energy_gap={best:+.4f} fixed={nfix:.0f}px")
            trainer.save(ts, 0, best=True)
        for epoch in range(args.num_epochs):
            ts, loss = trainer.train_epoch(ts, [train_ds], n_episodes=5)
            gap, nfix = score(ts)
            history.append({"epoch": epoch, "loss": loss, "gap": gap,
                            "n_fixed": nfix})
            log(f"epoch {epoch}: loss={loss:.5f} energy_gap={gap:+.4f} "
                f"fixed={nfix:.0f}px")
            trainer.save(ts, epoch)
            if best is None or gap < best:
                best = gap
                trainer.save(ts, epoch, best=True)
        return {"state": ts, "history": history, "best_gap": best}

    path = args.checkpoint or os.path.join(args.save_dir, "checkpoint",
                                           "best_checkpoint.npz")
    ts = trainer.load(path)
    compact = args.compact != 0
    t0 = time.perf_counter()
    state, res = l2f.l2f_solve_seg(
        eval_prob, trainer.variables(ts), cfg, pcfg, ws=args.ws,
        max_iter=args.max_eval_iters, compact=compact,
        refine_iters=args.refine_iters, refine_rounds=args.refine_rounds,
        refine_band=args.refine_band, repair_sweeps=args.repair_sweeps,
        pair_sweeps=args.pair_sweeps)
    sync(res["solution"])
    wall = time.perf_counter() - t0
    m = l2f.l2f_metrics_qp(state, eval_prob, eval_ds.oracle_obj, eval_labels,
                           repair_sweeps=args.repair_sweeps,
                           pair_sweeps=args.pair_sweeps)
    sol = res["solution"].cpu().numpy()
    mask = eval_prob.mask.cpu().numpy()
    for i, p in enumerate(eval_paths):
        name = os.path.splitext(os.path.basename(p))[0]
        seg.save_img(sol[i], mask[i], os.path.join(
            args.result_dir, f"l2f_output_{name}.png"))
    out = {k: (v.cpu().numpy() if hasattr(v, "cpu") else v)
           for k, v in m.items()}
    out.update(wall_s=wall, compact=compact,
               oracle_energy=eval_ds.oracle_obj.cpu().numpy(),
               oracle_iters=eval_ds.oracle_iters)
    log(f"[plain] mean energy {out['oracle_energy'].mean():.1f} "
        f"({eval_ds.oracle_iters} iters)")
    log(f"[l2f] energy gap {out['energy_gap'].mean():+.4f}, iters "
        f"{out['iterations']}, fixed {out['n_fixed'].mean():.0f}px, pixel "
        f"agreement {out['px_agree'].mean():.0f}, wall {wall:.2f}s"
        f"{' (compact)' if compact else ''}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
