"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names: the port's name, ``lpbox_admm_tpu_torch``,
begins with the JAX package's."""

import os
import subprocess
import sys

from benchmark import run as R
from benchmark.manifest import ROOT


def test_whole_names_are_compared(monkeypatch):
    for name in ("lpbox_admm_tpu_torch.core", "jaxtyping", "flaxen",
                 "jax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.setattr(sys, "modules", {k: v for k, v in sys.modules.items()
                                         if k.split(".")[0] not in
                                         R.FORBIDDEN})
    assert R.forbidden_loaded() == []
    for name in ("lpbox_admm_tpu", "jax.numpy", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert R.forbidden_loaded() == ["flax", "jax", "jaxlib",
                                    "lpbox_admm_tpu"]


def _python(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither():
    # a whole toy run on the CPU, every reader and the reference included
    code = """
import sys
from benchmark import run as R
from benchmark.tests.toy import toy_cell
if __name__ == "__main__":
    cell = toy_cell("ca500-l2f")
    r = R.Run(cell, 99, 0.2, False, device="cpu", workers=2)
    R.metrics(r)
    R.judge(r)
    from benchmark import control, trace, work
    from benchmark.manifest import manifest, reader
    b = manifest()
    for m in b["end_to_end"] + b["per_layer"]:
        reader(m["name"])
    print("LOADED", R.forbidden_loaded())
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "LOADED []" in p.stdout


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "ca500-l2f", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr
