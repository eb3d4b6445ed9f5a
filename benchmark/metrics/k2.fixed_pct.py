"""Variables the policy fixed (the ``n_fixed`` that
``train.l2f.l2f_solve_compact`` returns) over the instances' variables,
over the window, in %."""


def read(run):
    bs = [b for b in run["batches"] if b.get("n_fixed") is not None]
    if not bs:
        return None
    fixed = sum(float(b["n_fixed"].sum()) for b in bs)
    return 100.0 * fixed / sum(b["vars"] for b in bs)
