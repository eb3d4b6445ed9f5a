"""The port stands alone: it imports nothing of JAX or of the JAX
package, its CUDA entry points never fall back to the CPU, and
``chip_smoke.py`` fails (non-zero, no ``"ok": true``) where there is no
CUDA device or no repository beside it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lpbox_admm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lpbox_admm_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_forbidden_imports_in_source():
    files = _port_files()
    assert len(files) > 10
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


BLOCKED_IMPORT = """
import importlib, importlib.abc, pkgutil, sys
BLOCK = {blocked!r}
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
import lpbox_admm_tpu_torch
for m in pkgutil.walk_packages(lpbox_admm_tpu_torch.__path__,
                               "lpbox_admm_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
assert "lpbox_admm_tpu_torch.scripts.probe_dot" in sys.modules
for name in ("ops.sparse", "ops.mxu_sparse", "ops.ca_sparse",
             "ops.struct_ginv", "train.l2f_struct", "scripts.mega_l2f",
             "scripts.auto_rule", "ops.stencil", "core.qp", "core.general",
             "adapters.segmentation", "experiments.run_seg",
             "adapters.attack", "adapters.slic", "models.cifarnet",
             "experiments.run_attack"):
    assert "lpbox_admm_tpu_torch." + name in sys.modules, name
print("imports-ok")
"""


def test_port_imports_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT.format(blocked=FORBIDDEN)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert "imports-ok" in res.stdout


def test_cuda_default_does_not_fall_back_to_cpu():
    from lpbox_admm_tpu_torch.adapters import ca
    rng = np.random.RandomState(0)
    insts = [ca.generate_cauction(rng, n_items=20, n_bids=60)]
    if torch.cuda.is_available():
        assert ca.make_problem(insts).E.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        ca.make_problem(insts)
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    with pytest.raises(RuntimeError, match="cuda"):
        load_policy(str(ROOT / "checkpoints/ca500_mlp/checkpoint/"
                        "best_checkpoint.npz"))


def test_large_rung_entry_points_default_to_cuda():
    """The sparse, structured and bfloat16 problem builders, the Schur
    build and ``scripts.mega_l2f``'s helpers run on the card unless asked for
    the CPU: without a card they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from lpbox_admm_tpu_torch.adapters import ca
    from lpbox_admm_tpu_torch.ops import ca_sparse, sparse, struct_ginv
    from lpbox_admm_tpu_torch.scripts import mega_l2f
    from lpbox_admm_tpu_torch.train import l2f_struct
    inst = ca.generate_cauction(np.random.RandomState(0), n_items=20,
                                n_bids=60, return_coo=True)
    r, c, v, shape = inst[1]
    calls = [lambda: ca.make_sparse_problem([inst]),
             lambda: ca.make_struct_problem([inst]),
             lambda: ca.make_dense_bf16_problem([inst]),
             lambda: sparse.from_coo([(r, c, v)], shape),
             lambda: sparse.empty(1, 4, 4),
             lambda: ca_sparse.build([(r, c, v)], [shape], 64),
             lambda: struct_ginv.build_struct_ginv(
                 [(r, c, v)], [shape], [np.arange(shape[0])], 128, 0, 64,
                 2.0),
             lambda: mega_l2f.build_struct(inst),
             lambda: l2f_struct.window_decisions(
                 np.zeros((4, 100)), None, 100, 0.9, 1, 1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_segmentation_entry_points_default_to_cuda(tmp_path):
    """The segmentation and general-solver constructors and the run_seg
    entry point run on the card unless asked for the CPU: without a card they
    raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from lpbox_admm_tpu_torch.adapters import segmentation as seg
    from lpbox_admm_tpu_torch.core import general
    from lpbox_admm_tpu_torch.experiments import run_seg
    im = np.random.RandomState(0).rand(6, 8) * 0.9
    np.save(tmp_path / "0.npy", im)
    A, b = np.eye(3)[None], np.ones((1, 3))
    r, c = np.arange(3), np.arange(3)
    calls = [lambda: seg.make_problem([im]),
             lambda: seg.load_problem([str(tmp_path / "0.npy")]),
             lambda: general.make_general(A=A, b=b),
             lambda: general.make_sparse_general(b, A_coo=[(r, c, b[0])]),
             lambda: general.make_grid_general(np.zeros((1, 8, 2, 2)),
                                               np.ones((1, 4))),
             lambda: run_seg.main(["-phase", "solve", "-image_dir",
                                   str(tmp_path), "-n", "1", "-result_dir",
                                   str(tmp_path / "out")], log=print)]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert seg.make_problem([im], device="cpu").b.device.type == "cpu"


def test_attack_entry_points_default_to_cuda(tmp_path):
    """The victim loaders, ``run_attack`` and ``mega_l2f --phase train``
    run on the card unless asked for the CPU: without a card they raise
    instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from lpbox_admm_tpu_torch.experiments import run_attack
    from lpbox_admm_tpu_torch.models import cifarnet
    from lpbox_admm_tpu_torch.scripts import mega_l2f
    npz = str(ROOT / "checkpoints" / "cifar_victim.npz")
    calls = [lambda: cifarnet.init_victim(0),
             lambda: cifarnet.load_victim_npz(npz),
             lambda: cifarnet.victim_from_flax({"params": {}}),
             lambda: run_attack.main(["-phase", "solve", "-image_dir",
                                      str(tmp_path), "-result_dir",
                                      str(tmp_path / "out")], log=print),
             lambda: mega_l2f.main(["--phase", "train", "--rung", "50x300",
                                    "--seeds", "5,6", "--cache",
                                    str(tmp_path)])]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not cifarnet.init_victim(0, device="cpu").training


ATTACK_PIL_BLOCKED = """
import importlib.abc, sys
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "PIL":
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
from lpbox_admm_tpu_torch.adapters import attack, slic
from lpbox_admm_tpu_torch.experiments import run_attack
from lpbox_admm_tpu_torch.models import cifarnet
args = run_attack.parse_args(["-image_dir", "."])
try:
    run_attack.load_images(args)
except ImportError as e:
    assert "PIL" in str(e), e
else:
    raise AssertionError("no ImportError")
assert "PIL" not in sys.modules
print("attack-pil-free-ok")
"""


def test_attack_modules_import_without_pil():
    res = subprocess.run(
        [sys.executable, "-c", ATTACK_PIL_BLOCKED],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert "attack-pil-free-ok" in res.stdout


PIL_BLOCKED = """
import importlib.abc, sys
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "PIL":
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
import numpy as np
from lpbox_admm_tpu_torch.adapters import segmentation as seg
from lpbox_admm_tpu_torch.experiments import run_seg
im = np.random.RandomState(0).rand(6, 8) * 0.9
prob = seg.make_problem([im], device="cpu")
np.save({npy!r}, im)
assert (seg.load_image({npy!r}) == im).all()
for call in (lambda: seg.load_image("x.png"),
             lambda: seg.save_img(im, im > 0, "x.png")):
    try:
        call()
    except ImportError as e:
        assert "PIL" in str(e), e
    else:
        raise AssertionError("no ImportError")
assert "PIL" not in sys.modules
print("pil-free-ok")
"""


def test_segmentation_adapter_imports_without_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", PIL_BLOCKED.format(
            npy=str(tmp_path / "im.npy"))],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert "pil-free-ok" in res.stdout


def test_kernel_wrappers_refuse_other_devices():
    from lpbox_admm_tpu_torch.adapters import ca
    from lpbox_admm_tpu_torch.config import LP_CONFIG, PolicyConfig
    from lpbox_admm_tpu_torch.core import lp
    from lpbox_admm_tpu_torch.models import fused_policy
    from lpbox_admm_tpu_torch.ops import fused_lp
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    cfg = LP_CONFIG.replace(linsolve="woodbury")
    rng = np.random.RandomState(0)
    p = ca.make_problem([ca.generate_cauction(rng, n_items=20, n_bids=60)],
                        device="cpu")
    s = lp.init_state(p, cfg)
    meta = lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t
    pm = p.replace(**{f: meta(getattr(p, f)) for f in
                      ("b", "E", "f", "row_mask", "var_mask")})
    sm = s.replace(**{f: meta(getattr(s, f)) for f in
                      s.__dataclass_fields__ if f != "it"})
    with pytest.raises(ValueError, match="device"):
        fused_lp.lp_window_fused(sm, pm, cfg, 2)
    model = load_policy(str(ROOT / "checkpoints/ca500_mlp/checkpoint/"
                            "best_checkpoint.npz"), device="cpu")
    pk = fused_policy.pack_policy_weights(model)
    with pytest.raises(ValueError, match="device"):
        fused_policy.policy_scores_fused(pk, torch.zeros(3, 100,
                                                         device="meta"),
                                         PolicyConfig(net="mlp"))
    from lpbox_admm_tpu_torch.ops import fused_stream, symm
    carry = fused_stream._bootstrap(s, p, cfg)
    args = fused_stream._sweep_args(carry, p.E, p, s.free.float(), cfg)
    with pytest.raises(ValueError, match="device"):
        fused_stream.sweep_cuda(*(meta(a) for a in args))
    with pytest.raises(ValueError, match="device"):
        fused_stream.sweep(*(meta(a) for a in args))
    with pytest.raises(ValueError, match="device"):
        fused_stream.lp_window_stream(sm, pm, cfg, 2)
    Gp = symm.pack_tril(torch.zeros(1, 256, 256))
    v = torch.zeros(1, 256)
    for fn in (symm.symm_matvec_cuda, symm.symm_matvec):
        with pytest.raises(ValueError, match="device"):
            fn(meta(Gp), meta(v))
    with pytest.raises(ValueError, match="device"):
        symm.symm_matvec_cuda(Gp, v)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    from lpbox_admm_tpu_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert [p.name for p in build.sources()] == [
        "lp_window.cu", "lp_window_cluster.cu", "policy.cu", "probe_dot.cu",
        "stream_sweep.cu", "symm.cu"]


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke runs for real")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert not (tmp_path / "lpbox_admm_tpu_torch").exists()
