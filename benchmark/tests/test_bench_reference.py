"""The plain reference at toy sizes on the CPU, against the program's own
plain versions (which it never imports at run time)."""

import os

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark import reference as ref
from benchmark.manifest import ROOT

CKPT = os.path.join(ROOT, "checkpoints", "ca500_mha", "checkpoint",
                    "best_checkpoint.npz")
SOLVER = dict(stop_threshold=1e-4, std_threshold=1e-12, history_size=10,
              initial_rho=25.0, learning_fact=1.01, rho_change_step=25,
              gamma0=1.6, gamma_factor=0.95, pcg_tol=1e-3,
              incumbent_stride=8, feasible_incumbent=True)


@pytest.fixture(scope="module")
def toy():
    from lpbox_admm_tpu_torch.adapters import ca
    from lpbox_admm_tpu_torch.config import LP_CONFIG
    insts = [gen.instance(5, i, 20, 60) for i in range(4)]
    dense = []
    for p, r, c, (m, n) in insts:
        C = np.zeros((m, n))
        C[r, c] = 1
        dense.append((p, C))
    prob = ca.make_problem(dense, device="cpu")
    cfg = LP_CONFIG.replace(linsolve="woodbury", incumbent_stride=8)
    return insts, prob, cfg


def _state(a):
    st = {k: getattr(a, k) for k in (
        "x", "z1", "z2", "z4", "f_eff", "free", "rmask", "ring", "count",
        "done", "cur_obj", "best_obj", "best_sol")}
    st["b"] = a.b
    return st


@pytest.mark.parametrize("steps,it0", [(1, 0), (6, 0), (6, 400)])
def test_window_follows_the_program_mside(toy, steps, it0):
    from lpbox_admm_tpu_torch.core import lp
    from lpbox_admm_tpu_torch.ops import fused_lp
    _, prob, cfg = toy
    s0 = lp.init_state(prob, cfg).replace(it=it0)
    a = fused_lp.window_inputs(s0, prob, cfg)
    out = fused_lp.window_plain(a, cfg, it0, steps, skip_cvg_at=0)
    want = ref.window(_state(a), prob.E, SOLVER, it0, steps, 0, False,
                      "float64")
    assert (out.x.double() - want["x"]).abs().max() < 1e-4
    assert torch.equal(out.done > 0, want["done"])


def test_window_follows_the_program_nside(toy):
    from lpbox_admm_tpu_torch.core import lp
    from lpbox_admm_tpu_torch.ops import fused_lp, woodbury
    _, prob, cfg = toy
    s0 = lp.init_state(prob, cfg)
    a0 = fused_lp.window_inputs(s0, prob, cfg)
    s1 = fused_lp.window_state(s0, prob, cfg, 20,
                               fused_lp.window_plain(a0, cfg, 0, 20, 0),
                               False)
    sc, pc, _ = lp.compact(s1, prob, cfg, 64, m_new=64)
    nf = woodbury.factorize_nside(pc.E, sc.free, 2.0)
    a = fused_lp.window_inputs(sc, pc, cfg, (nf.hinv, nf.ete))
    out = fused_lp.window_plain(a, cfg, sc.it, 5)
    want = ref.window(_state(a), pc.E, SOLVER, sc.it, 5, None, True,
                      "float64")
    assert (out.x.double() - want["x"]).abs().max() < 1e-4


def test_tf32_control_moves_the_window(toy):
    from lpbox_admm_tpu_torch.core import lp
    from lpbox_admm_tpu_torch.ops import fused_lp
    _, prob, cfg = toy
    a = fused_lp.window_inputs(lp.init_state(prob, cfg), prob, cfg)
    st = _state(a)
    hi = ref.window(st, prob.E, SOLVER, 0, 40, 0, False, "float64")
    lo = ref.window(st, prob.E, SOLVER, 0, 40, 0, False, "tf32")
    assert (hi["x"] - lo["x"].double()).abs().max() > 1e-3


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265])
    y = ref.tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2 ** -10
    assert y[1] in (1.0, 1.0 + 2 ** -10)
    assert abs(float(y[3]) - 3.14159265) < 2 ** -10 * 4


def test_policy_matches_the_programs_module():
    from lpbox_admm_tpu_torch.train.l2f import policy_scores
    from lpbox_admm_tpu_torch.config import PolicyConfig
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    model = load_policy(CKPT, device="cpu")
    rows = torch.rand(300, 100, generator=torch.Generator().manual_seed(1))
    got = policy_scores(model, rows, PolicyConfig(net="mha"))
    want = ref.Policy(CKPT, 20, 5, 5, 8, "cpu", "float64").scores(rows)
    assert (got.double() - want).abs().max() < 1e-5
    low = ref.Policy(CKPT, 20, 5, 5, 8, "cpu", "tf32").scores(rows)
    assert (low.double() - want).abs().max() > 1e-4


def test_selection_equals_the_programs(toy):
    from lpbox_admm_tpu_torch.core import lp
    _, prob, _ = toy
    g = torch.Generator().manual_seed(2)
    for trial in range(4):
        last = (torch.rand(prob.b.shape, generator=g) < 0.15).float() \
            * prob.var_mask
        best = (torch.rand(prob.b.shape, generator=g) < 0.05).float() \
            * prob.var_mask
        sol, obj, _ = lp.select_solution(prob, last, best, repair_rounds=16,
                                         swap_rounds=4,
                                         drop_rounds=8 * (trial % 2))
        want = ref.select(prob.b, prob.E, prob.f, prob.row_mask,
                          prob.var_mask, last, best, 16, 4,
                          8 * (trial % 2))
        assert torch.equal(sol, want)


def test_compaction_equals_the_programs(toy):
    from lpbox_admm_tpu_torch.core import lp
    _, prob, cfg = toy
    s = lp.init_state(prob, cfg)
    g = torch.Generator().manual_seed(3)
    free = prob.var_mask & (torch.rand(prob.b.shape, generator=g) < 0.4)
    s = s.replace(free=free)
    _, p2, idx = lp.compact(s, prob, cfg, 64, m_new=64)
    E2, cols = ref.compact_E(prob.E, free, prob.row_mask, 64, 64)
    assert torch.equal(cols, idx) and torch.equal(E2, p2.E)


def test_evaluate_and_greedy(toy):
    insts, prob, _ = toy
    p, r, c, (m, n) = insts[0]
    g = ref.greedy_objective(p, r, c, m)
    assert g < 0
    E = ref.dense_E(r, c, (m, n), 128, 128, "cpu")[None]
    b = -torch.as_tensor(np.pad(p, (0, 128 - n)), dtype=torch.float32)[None]
    vm = torch.arange(128)[None] < n
    empty = torch.zeros((1, 128))
    ok, over, obj = ref.evaluate(empty, E, b, vm)
    assert bool(ok[0]) and int(over[0]) == 0 and float(obj[0]) == 0
    full = vm.float()
    ok, over, _ = ref.evaluate(full, E, b, vm)
    assert bool(ok[0]) and int(over[0]) > 0
    half = full * 0.5
    assert not bool(ref.evaluate(half, E, b, vm)[0][0])
    pad = torch.zeros((1, 128))
    pad[0, 127] = 1
    assert not bool(ref.evaluate(pad, E, b, vm)[0][0])
