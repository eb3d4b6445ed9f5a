"""Problem families as kinds (``kinds/<kind>.py``): the auction kind keeps
the pool files, the uploaded tensors and the numbers the harness had
before kinds; a second kind comes as new files alone; an unknown kind is
refused."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark import run as R
from benchmark.manifest import HERE, ROOT, Cell, kind
from benchmark.tests.toy import toy_cell, toy_routes

SEED = 2**31 + 4242

#: the toy cells' numbers at SEED with a window of 0 s (the captured
#: batch's two batches), one CPU thread, as the harness read them before
#: the problem family moved into ``kinds/cauction.py``: the program's and
#: the control's
PINNED = {
    "ca500-l2f": (
        {"infeasible": 0, "obj_err": 7.256250395012131e-08,
         "gap_greedy": -0.15714246590227454, "select_diff": 0,
         "k2_err": 3.4019227795889506e-07, "fix_diff": 0,
         "window_operand": 0, "ex_err": 3.5623786970973015e-05,
         "iter_err": 2.7768162565278143e-05,
         "tail_iters": -0.02639296187683282,
         "tail_stall": 0.1541445083881844},
        {"infeasible": 0, "obj_err": 7.256250395012131e-08,
         "gap_greedy": -0.15714246590227454, "select_diff": 0,
         "k2_err": 0.0006823901477334693, "fix_diff": 0,
         "window_operand": 0, "ex_err": 0.08820088393986225,
         "iter_err": 0.0382109718588598, "tail_iters": -0.1730205278592376,
         "tail_stall": 0.03356463946689714}),
    "xl-l2f": (
        {"infeasible": 0, "obj_err": 3.709023254790169e-08,
         "gap_greedy": -0.04853405445328836, "select_diff": 0,
         "k2_err": 4.824726916874411e-07, "fix_diff": 0,
         "window_operand": 0, "ex_err": 2.844352275133133e-05,
         "iter_err": 1.9127420565534514e-05,
         "tail_iters": 0.06563706563706562, "tail_stall": 0.0},
        {"infeasible": 0, "obj_err": 3.709023254790169e-08,
         "gap_greedy": -0.04853405445328836, "select_diff": 0,
         "k2_err": 0.0008369978628160468, "fix_diff": 0,
         "window_operand": 0, "ex_err": 0.054104981012642384,
         "iter_err": 0.039647916680777655,
         "tail_iters": -0.18800118800118804,
         "tail_stall": 0.0067038506787181484}),
    "ca500-plain": (
        {"infeasible": 0, "obj_err": 7.256250395012131e-08,
         "gap_greedy": -0.18586249815047723, "select_diff": 0,
         "window_operand": 0, "ex_err": 4.909420385956764e-05,
         "iter_err": 0.004138371216375572},
        {"infeasible": 0, "obj_err": 7.256250395012131e-08,
         "gap_greedy": -0.18586249815047723, "select_diff": 0,
         "window_operand": 0, "ex_err": 0.08838910365011543,
         "iter_err": 0.6835017701129846}),
}


@pytest.mark.parametrize("name,key", [
    ("ca500-l2f", "cauction-n_bids500-n_items100-seed0-size256.npz"),
    ("ca500-plain", "cauction-n_bids500-n_items100-seed0-size256.npz"),
    ("xl-l2f", "cauction-n_bids4000-n_items800-seed0-size32.npz")])
def test_ca_kind_keeps_its_pool_key(name, key):
    cell = Cell(name)
    k, params, size = R.pool_params(cell)
    path = R.pool_file(k, params, cell.traffic["pool_seed"], size)
    assert path == os.path.join(R.POOL_DIR, key)


def test_ca_kind_uploads_the_same_tensors():
    ca = kind("cauction")
    insts = [gen.instance(2**31 + 3, i, 20, 60) for i in range(3)]
    gather = ca.upload(R.load_port("cpu"), insts,
                       {"m_pad": 128, "n_pad": 128}, "cpu")
    idx = np.array([2, 0])
    prob = gather(idx)
    for k, i in enumerate(idx):
        prices, rows, cols, (m, n) = insts[i]
        E = torch.zeros((128, 128))
        E[torch.as_tensor(rows, dtype=torch.long),
          torch.as_tensor(cols, dtype=torch.long)] = 1.0
        b = torch.zeros(128)
        b[:n] = torch.as_tensor(-prices, dtype=torch.float32)
        assert torch.equal(prob.E[k], E) and torch.equal(prob.b[k], b)
        assert torch.equal(prob.f[k], torch.ones(128))
        assert torch.equal(prob.row_mask[k], torch.arange(128) < m)
        assert torch.equal(prob.var_mask[k], torch.arange(128) < n)
        assert ca.variables(insts[i]) == n
    assert [t.dtype for t in (prob.E, prob.b, prob.f, prob.row_mask,
                              prob.var_mask)] == [torch.float32] * 3 + \
        [torch.bool] * 2


@pytest.mark.parametrize("name", sorted(PINNED))
def test_toy_numbers_as_before_kinds(name):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = toy_cell(name)
        # the check's plan as the harness had it: K1's cluster groups
        # (``check.k1_cluster``) came later, with numbers of their own
        cell.traffic = dict(cell.traffic, check={
            k: v for k, v in cell.traffic["check"].items()
            if k != "k1_cluster"})
        with toy_routes(cell):
            r = R.Run(cell, SEED, 0.0, False, device="cpu", workers=2)
        program = R.judge(r)[2]
        control = R.judge(r, control=True)[2]
    finally:
        torch.set_num_threads(threads)
    assert (len(r.batches), r.captured_batch) == (2, 1)
    assert (program, control) == PINNED[name]


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError, match=r"no kind 'setcover'.*cauction"):
        kind("setcover")
    with pytest.raises(ValueError, match="no kind"):
        kind("../run")
    cell = Cell("ca500-l2f")
    cell.config = dict(cell.config, instance=dict(cell.config["instance"],
                                                  kind="setcover"))
    with pytest.raises(ValueError, match="there are"):
        R.start_pool(cell, 1, workers=1)


@pytest.mark.parametrize("module", ["run", "check", "capture", "faults",
                                    "control", "manifest"])
def test_harness_names_no_kind(module):
    # the auction family lives in kinds/cauction.py (and the LP entries
    # and readers): the harness neither imports its generator, its
    # reference layout or its problem object, nor wraps the LP solver
    with open(os.path.join(HERE, module + ".py")) as f:
        src = f.read()
    for word in ("cauction", "import gen", "gen.", "dense_E", "LpProblem",
                 '"fused_lp", "', '"lp", "', "select_solution",
                 "window_cuda", "solve_window"):
        assert word not in src, word


# --- a second kind, as new files ---------------------------------------------

#: an unconstrained binary QP, min x.Ax + b.x over {0, 1}^n, solved by
#: the port's general solver; the reference finds the optimum by
#: enumeration
QP_KIND = '''
"""Unconstrained binary QPs of n variables (a test's kind)."""

import numpy as np
import torch

FAULTS = {"answer-altered": [
    ("lpbox_admm_tpu_torch.core.general", "objective",
     lambda fn, mod: lambda state, prob: fn(state, prob) + 1.0)]}


def make(seed, index, n):
    rng = np.random.RandomState(
        np.random.SeedSequence([seed, index]).generate_state(8))
    A = rng.randn(n, n)
    return (A + A.T) / 2, rng.randn(n)


def save(path, instances):
    with open(path, "wb") as f:
        np.savez(f, A=np.stack([a for a, _ in instances]),
                 b=np.stack([b for _, b in instances]))


def load(path):
    with np.load(path) as z:
        return list(zip(z["A"], z["b"]))


def variables(instance):
    return len(instance[1])


def upload(port, instances, instance_cfg, device):
    from lpbox_admm_tpu_torch.core import general
    prob = general.make_general(A=np.stack([a for a, _ in instances]),
                                b=np.stack([b for _, b in instances]),
                                device=device)

    def gather(idx):
        it = torch.as_tensor(idx, device=device)
        return general.GeneralProblem(
            A=prob.A[it], b=prob.b[it], C=prob.C[it], d=prob.d[it],
            E=prob.E[it], f=prob.f[it], var_mask=prob.var_mask[it])
    return gather


class Capture:
    def __init__(self, rec, check_plan, pick):
        pass

    def wraps(self):
        return []

    def batch(self):
        pass

    def work(self):
        return {}


class RefPool:
    def __init__(self, instances, instance_cfg, device):
        n = len(instances[0][1])
        xs = torch.tensor([[(k >> j) & 1 for j in range(n)]
                           for k in range(2 ** n)], dtype=torch.float64)
        self.A = torch.tensor(np.stack([a for a, _ in instances]))
        self.b = torch.tensor(np.stack([b for _, b in instances]))
        self.A32 = self.A.float().double()
        self.b32 = self.b.float().double()
        obj = torch.einsum("kn,pnm,km->pk", xs, self.A32, xs) \\
            + self.b32 @ xs.T
        self.opt = obj.min(-1).values


def numbers(pool, batches, captured, rec, cfg, ckpt, control=False,
            witness=False):
    bad, err, gap, count = 0, 0.0, 0.0, 0
    for bt in batches:
        idx = torch.as_tensor(bt["idx"])
        x = bt["sol"].double().cpu()
        bad += int((~((x == 0) | (x == 1)).all(-1)).sum())
        want = torch.einsum("bn,bnm,bm->b", x, pool.A32[idx], x) \\
            + (pool.b32[idx] * x).sum(-1)
        got = bt["obj"].double().cpu()
        err = max(err, float(((got - want).abs()
                              / want.abs().clamp_min(1.0)).max()))
        opt = pool.opt[idx]
        gap += float(((want - opt) / opt.abs().clamp_min(1.0)).sum())
        count += len(idx)
    return {"infeasible": bad, "obj_err": err, "gap_opt": gap / count}
'''

QP_ENTRY = '''
"""The general solver from x = 1/2 to its cap or every instance done,
then the final rounding."""


def build(port, setting):
    import torch
    from lpbox_admm_tpu_torch.core import general
    cfg, args = setting["cfg"], setting["args"]

    def solve(prob, traced):
        st = general.init_state(prob, cfg, torch.full_like(prob.b, 0.5))
        while st.it < args["max_iters"] and not bool(st.done.all()):
            st, _ = general.solve_window(st, prob, cfg, args["window"],
                                         record=False)
        return {"sol": general.solution(st),
                "obj": general.objective(st, prob)}
    return solve
'''


def _second_kind(root):
    """A copy of the harness with the QP kind's files added."""
    shutil.copytree(HERE, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "benchmark", "configs", "ca500.json")) as f:
        solver = json.load(f)["solver"]
    files = {
        "kinds/bqp.py": QP_KIND,
        "entries/bqp.py": QP_ENTRY,
        "configs/bqp8.json": json.dumps({
            "name": "bqp8", "source": "a test's deployment",
            "instance": {"kind": "bqp", "n": 8}, "allow_tf32": False,
            "solver": dict(solver, linsolve="pcg")}),
        "traffic/bqp-b4-pool8.json": json.dumps({
            "entry": "bqp", "policy": False, "batch": 4, "pool": 8,
            "draw": "sample", "warmup_batches": 1, "pool_seed": 0,
            "args": {"max_iters": 1000, "window": 100},
            "check": {"batch_of": 2}}),
        "limits/bqp8-plain.json": json.dumps({"numbers": {
            "infeasible": 0, "obj_err": 1e-4, "gap_opt": 0.1}}),
    }
    for rel, text in files.items():
        with open(os.path.join(root, "benchmark", rel), "w") as f:
            f.write(textwrap.dedent(text))
    bench = {"command": ["python3", "-m", "benchmark.run"],
             "paths": ["benchmark"], "run_seconds": 10,
             "configs": [{"name": "bqp8", "source": "a test",
                          "file": "benchmark/configs/bqp8.json",
                          "reduced": [], "why": "a test"}],
             "workloads": [{"name": "bqp8-plain", "config": "bqp8",
                            "traffic": "bqp-b4-pool8", "chips": 1,
                            "why": "a test"}],
             "end_to_end": [m for m in json.load(open(os.path.join(
                 ROOT, "BENCHMARK.json")))["end_to_end"]
                 if m["name"] in ("instances_per_s", "setup_s")],
             "per_layer": []}
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def test_second_kind_comes_as_new_files(tmp_path):
    _second_kind(str(tmp_path))
    for sub in ("run.py", "check.py", "capture.py", "faults.py",
                "control.py", "manifest.py"):
        with open(os.path.join(HERE, sub)) as a, \
                open(tmp_path / "benchmark" / sub) as b:
            assert a.read() == b.read()
    code = """
import json
from benchmark import faults, run as R
from benchmark.manifest import Cell, kind
if __name__ == "__main__":
    cell = Cell("bqp8-plain")
    out = {}
    r = R.Run(cell, 2**31 + 5, 0.2, False, device="cpu", workers=2)
    out["sound"] = R.judge(r)[:3]
    out["metrics"] = sorted(R.metrics(r))
    out["batches"] = len(r.batches)
    port = R.load_port("cpu")
    faults.plant("answer-altered", port, kind("bqp"))
    r = R.Run(cell, 2**31 + 6, 0.0, False, device="cpu", workers=1,
              port=port)
    out["fault"] = R.judge(r)[:3]
    print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    ok, failed, nums = out["sound"]
    assert ok and failed == 0, nums
    assert out["metrics"] == ["instances_per_s", "setup_s"]
    assert out["batches"] >= 1
    assert (tmp_path / ".bench_cache" / "pools" /
            "bqp-n8-seed0-size8.npz").exists()
    ok, failed, nums = out["fault"]
    assert not ok and nums["obj_err"] > 0.1, nums
