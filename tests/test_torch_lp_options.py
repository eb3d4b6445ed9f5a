"""The dense-LP options of ``core/lp.py`` against the JAX package (CPU):
bfloat16 E in the iteration (three limbs, ``_mv``), bfloat16 storage
of G^{-1} (``_ginv_store``) and rule-based fixing (``fix_count``,
``rule_fix_vec``, ``solve(rule_fixing=True)``), on CA 20x60 batches.

Tolerances: the three-limb products 1e-6 of max |ref| against the JAX
package's (both sum float32 products of the same limbs, in another
order); a one-limb product (the planted fault) is about 1e-3 off, so it
must miss that bound.  ``_ginv_store`` bit for bit on the same float32
factor.  Twenty rule-fixing iterations from the same state: the
iterates to 1e-3 in the units of x, the counters and the decision
vector equal.  Rule-fixing solves run to convergence: 0 infeasible,
fixes made, converged objectives within 5% (chaotic trajectories)
between the port on float32 E, the port on bfloat16 E with bfloat16
G^{-1}, and the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.config import LP_CONFIG as JLP
from lpbox_admm_tpu.core import lp as jlp
from lpbox_admm_tpu_torch.config import LP_CONFIG as TLP
from lpbox_admm_tpu_torch.core import lp as tlp
from lpbox_admm_tpu_torch.ops import mxu_sparse

from torch_port_util import (ca_instances, np_of, problems, rel,
                             state_errors, torch_state)

CFG_J = JLP.replace(linsolve="woodbury")
CFG_T = TLP.replace(linsolve="woodbury")
EMV_TOL = 1e-6
ITERS = 6000


@pytest.fixture(scope="module")
def probs():
    return problems(ca_instances(31, 3))


def _rel(a, b):
    a, b = np_of(a).astype(np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _vectors(B, m, n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-2, 2, (B, n)).astype(np.float32),
            rng.uniform(-100, 100, (B, m)).astype(np.float32))


def _one_limb_mv(E16, v):
    """The planted fault: v rounded to one bfloat16 limb."""
    return tlp._bf16_bmm(E16, mxu_sparse._limbs3(v)[..., :1])[..., 0]


def test_emv_bf16_matches_jax_and_one_limb_fails(probs):
    jp, tp = probs
    B, m, n = tp.E.shape
    v, w = _vectors(B, m, n)
    E16_t, E16_j = tp.E.to(torch.bfloat16), jp.E.astype(jnp.bfloat16)
    ref_mv = jlp._emv("bmn,bn->bm", E16_j, jnp.asarray(v))
    ref_mtv = jlp._emv("bmn,bm->bn", E16_j, jnp.asarray(w))
    assert _rel(tlp._mv(E16_t, torch.from_numpy(v)), ref_mv) <= EMV_TOL
    assert _rel(tlp._mtv(E16_t, torch.from_numpy(w)), ref_mtv) <= EMV_TOL
    # stacked forms (the step's forward and transpose passes)
    V = np.stack([v, 2 * v], axis=1)
    W = np.stack([w, -w, 0.5 * w], axis=1)
    assert _rel(tlp._mv_many(E16_t, torch.from_numpy(V)),
                jlp._emv("bmn,bkn->bkm", E16_j, jnp.asarray(V))) <= EMV_TOL
    assert _rel(tlp._mtv_many(E16_t, torch.from_numpy(W)),
                jlp._emv("bmn,bkm->bkn", E16_j, jnp.asarray(W))) <= EMV_TOL
    # bfloat16 G^-1 through the same limbs
    g = np.array(jlp.init_state(jp, CFG_J).ginv)
    g16_j = jnp.asarray(g).astype(jnp.bfloat16)
    g16_t = torch.from_numpy(g).to(torch.bfloat16)
    assert _rel(tlp._ginv_apply(g16_t, torch.from_numpy(w)),
                jlp._emv("bmk,bk->bm", g16_j, jnp.asarray(w))) <= EMV_TOL
    # the planted one-limb product misses the bound
    assert _rel(_one_limb_mv(E16_t, torch.from_numpy(v)), ref_mv) > 1e2 * EMV_TOL


def test_limbs_equal_jax_reduce_precision():
    """The three limbs are the JAX package's bit for bit (round to
    nearest even of what the earlier limbs leave)."""
    from lpbox_admm_tpu.ops.mxu_sparse import _limbs3 as jlimbs
    x = np.random.RandomState(1).randn(4, 257).astype(np.float32) * 1e3
    np.testing.assert_array_equal(
        mxu_sparse._limbs3(torch.from_numpy(x)).float().numpy(),
        np.asarray(jlimbs(jnp.asarray(x)).astype(jnp.float32)))


def test_ginv_store_bit_for_bit(probs):
    jp, _ = probs
    g = np.array(jlp.init_state(jp, CFG_J).ginv)
    for dt in ("float32", "bfloat16"):
        gj = jlp._ginv_store(jnp.asarray(g), CFG_J.replace(ginv_dtype=dt))
        gt = tlp._ginv_store(torch.from_numpy(g), CFG_T.replace(ginv_dtype=dt))
        assert str(gt.dtype).endswith(dt) and gj.dtype == jnp.dtype(dt)
        np.testing.assert_array_equal(
            gt.float().numpy(), np.asarray(gj.astype(jnp.float32)))


def test_step_bf16_e_matches_jax(probs):
    """``matvec_dtype="bfloat16"`` in ``core.lp`` windows (refused before
    this port): 20 iterations from the same state to 1e-3 of x."""
    jp, tp = probs
    cfg_j = CFG_J.replace(matvec_dtype="bfloat16")
    cfg_t = CFG_T.replace(matvec_dtype="bfloat16")
    js0 = jlp.init_state(jp, CFG_J)
    js, _ = jlp.solve_window(js0, jp, cfg_j, 20, record=False, skip_cvg_at=0)
    ts, _ = tlp.solve_window(torch_state(js0), tp, cfg_t, 20, record=False,
                             skip_cvg_at=0)
    assert max(state_errors(ts, js, CFG_T).values()) <= 1e-3


def test_rule_fix_counters_match_jax(probs):
    """Twenty rule-fixing iterations from the same state: iterates to
    1e-3 of x, ``fix_count`` and ``rule_fix_vec`` equal."""
    jp, tp = probs
    cfg_j = CFG_J.replace(consistency=3)
    cfg_t = CFG_T.replace(consistency=3)
    js0 = jlp.init_state(jp, cfg_j)
    js, _ = jlp.solve_window(js0, jp, cfg_j, 20, record=False,
                             skip_cvg_at=0, rule_fixing=True)
    ts, _ = tlp.solve_window(torch_state(js0), tp, cfg_t, 20, record=False,
                             skip_cvg_at=0, rule_fixing=True)
    assert max(state_errors(ts, js, CFG_T).values()) <= 1e-3
    np.testing.assert_array_equal(np_of(ts.fix_count),
                                  np.asarray(js.fix_count))
    vj = np.asarray(jlp.rule_fix_vec(js, cfg_j))
    np.testing.assert_array_equal(np_of(tlp.rule_fix_vec(ts, cfg_t)), vj)
    assert (vj >= 0).sum() > 0
    # and without rule_fixing the counters stay put
    tn, _ = tlp.solve_window(torch_state(js0), tp, cfg_t, 5, record=False)
    assert int(tn.fix_count.abs().sum()) == 0


def test_rule_fixing_solves_converge():
    """``solve(rule_fixing=True)``: the port on float32 E, on bfloat16 E
    with bfloat16 G^{-1}, and the JAX package, each to convergence or
    ITERS iterations (bfloat16 G^{-1} rarely meets the dual stop, as
    the JAX package notes): fixes made, 0 infeasible, selected
    objectives within 5% of one another."""
    jp, tp = problems(ca_instances(3, 3))
    objs, fixes = {}, {}
    # 60-bid instances: iterates that settle to 1e-2, rounds of 3 or more
    cfg_t = CFG_T.replace(min_fix=2, fix_threshold=1e-2)
    cfg_j = CFG_J.replace(min_fix=2, fix_threshold=1e-2)
    for tag, cfg in (("f32", cfg_t),
                     ("bf16", cfg_t.replace(matvec_dtype="bfloat16",
                                            ginv_dtype="bfloat16"))):
        st = tlp.solve(tp, cfg, max_iters=ITERS, rule_fixing=True)
        _, obj, inf = tlp.select_solution(tp, tlp.solution(st),
                                          tlp.solution_best(st))
        assert int(inf.sum()) == 0, tag
        objs[tag] = float(obj.mean())
        fixes[tag] = int((~st.free & tp.var_mask).sum())
    js = jlp.solve(jp, cfg_j, max_iters=ITERS, rule_fixing=True)
    _, jobj, jinf = jlp.select_solution(jp, jlp.solution(js),
                                        jlp.solution_best(js))
    assert int(np.asarray(jinf).sum()) == 0
    objs["jax"] = float(np.asarray(jobj).mean())
    fixes["jax"] = int((~np.asarray(js.free) & np.asarray(jp.var_mask)).sum())
    assert min(fixes.values()) > 0, fixes
    ref = objs["jax"]
    assert all(abs(o - ref) <= 0.05 * abs(ref) for o in objs.values()), objs
