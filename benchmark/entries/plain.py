"""The plain solve: ``ops.fused_lp.solve_fused`` (K1 windows from the
first iteration to the iteration cap or every instance done), then
``core.lp.select_solution`` with repair.

A traced batch runs under the program's tracer
(``utils.profiling.PhaseTimer``, one wait at the end, as
``train.l2f.l2f_solve_compact`` runs it) and returns the ``timings``
that ``l2f_solve_compact`` would give for these sites: each span the
program names under its key (``train.l2f.SPAN_KEYS``; here
``woodbury.factor``, the first factor, and ``lp.select`` read), the
host reads per site and the host's wait in them, and K1's cluster notes
(``k1_splits``, ``k1_split_launches``, ``k1_sm_pct``)."""


def build(port, setting):
    from lpbox_admm_tpu_torch.utils import profiling
    fused_lp, lp = port["fused_lp"], port["lp"]
    cfg = setting["cfg"]
    args = dict(setting["args"])
    window = args.pop("window")
    max_iters = args.pop("max_iters", cfg.max_iters)

    def solve(prob, traced):
        tracer = profiling.PhaseTimer(prob.device) if traced else None
        with profiling.tracing(tracer):
            st = fused_lp.solve_fused(prob, cfg, max_iters=max_iters,
                                      window=window)
            sol, obj, _ = lp.select_solution(prob, lp.solution(st),
                                             lp.solution_best(st), **args)
        return {"sol": sol, "obj": obj,
                "timings": timings(tracer, port["l2f"].SPAN_KEYS)
                if traced else None}
    return solve


def timings(tracer, span_keys: dict) -> dict:
    """The tracer's spans, reads and notes of one batch, under
    ``l2f_solve_compact``'s ``timings`` keys (``span_keys``: span name
    to key)."""
    sites = tracer.finish().reads()
    sums = tracer.sums()
    splits = tracer.notes.get("k1.split", [])
    out = {key: sums.get(name, 0.0) for name, key in span_keys.items()}
    out.update(host_read_sites=sites, host_reads=sum(sites.values()),
               host_read_wait_s=tracer.read_wait, k1_splits=splits,
               k1_split_launches=sum(c > 1 for _, c, _ in splits))
    pcts = [p for _, _, p in splits if p is not None]
    if pcts:
        out["k1_sm_pct"] = sum(pcts) / len(pcts)
    return out
