"""The port's batched-matvec probe (``lpbox_admm_tpu_torch.scripts.
probe_dot``) against the JAX package's TPU kernels of
``scripts/probe_dot.py`` (CPU).

That script does all its work when it is imported (and points JAX's
compilation cache into the repository), so it is never imported here:
its three kernel functions are taken from its source with ``ast`` and
run in a namespace that binds ``jax``, ``jnp`` and the shape, through
``pl.pallas_call(..., interpret=True)``.  Each is held, with the port's
plain version of the same formulation, against the float64 einsum on
the same seed-made inputs: 1e-5 of max |ref| (f32 sums of n products in
another order).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lpbox_admm_tpu_torch.scripts import probe_dot

import torch_port_util  # noqa: F401  (one intra-op thread per worker)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "probe_dot.py"
JAX_KERNEL = {"batched_dot": "k_batched", "pairs": "k_pairs",
              "vpu": "k_vpu"}
SHAPES = [(8, 256, 256), (2, 16, 32), (3, 8, 64)]


def jax_kernel(name, bt, m, n):
    """The JAX script's kernel function ``name``, bound to (bt, m, n)."""
    tree = ast.parse(SCRIPT.read_text(), str(SCRIPT))
    fn = [node for node in tree.body
          if isinstance(node, ast.FunctionDef) and node.name == name]
    assert len(fn) == 1, name
    ns = {"jax": jax, "jnp": jnp, "bt": bt, "m": m, "n": n}
    exec(compile(ast.Module(body=fn, type_ignores=[]), str(SCRIPT), "exec"),
         ns)
    return ns[name]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", probe_dot.NAMES)
def test_probe_matches_jax_kernel(name, shape):
    bt, m, n = shape
    E, v = probe_dot.make_inputs(bt, m, n, seed=sum(shape))
    want = np.einsum("bmn,bn->bm", E.astype(np.float64), v.astype(np.float64))
    tol = 1e-5 * np.abs(want).max()
    kernel = jax_kernel(JAX_KERNEL[name], bt, m, n)
    yj = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((bt, m), jnp.float32),
        interpret=True)(jnp.asarray(E), jnp.asarray(v)))
    yt = probe_dot.matvec(name, torch.from_numpy(E),
                          torch.from_numpy(v)).numpy()
    assert yt.shape == yj.shape == (bt, m) and yt.dtype == np.float32
    assert np.abs(yj - want).max() <= tol
    assert np.abs(yt - want).max() <= tol
    assert np.abs(yt - yj).max() <= tol


def test_probe_entry_point_on_cpu(capsys):
    assert probe_dot.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    ok = [ln for ln in lines[1:] if ": OK maxerr=" in ln]
    assert [ln.split(":")[0] for ln in ok] == list(probe_dot.NAMES)
    assert len(lines) == 1 + len(probe_dot.NAMES)


@pytest.mark.parametrize("name,shape,match", [
    ("batched_dot", (2, 8, 30), "multiple of 4"),
    ("batched_dot", (2, 8, 12292), "at most 12288"),
    ("pairs", (65, 8, 32), "over 64"),
    ("vpu", (2, 8, 32, 1), "expected E"),
])
def test_probe_refuses_shapes_before_launch(name, shape, match):
    """Shapes a kernel does not take are refused before any launch (meta
    tensors: nothing is allocated); a shape it takes on a device other
    than CUDA is refused too."""
    E = torch.empty(shape, device="meta")
    v = torch.empty(shape[0], shape[-1], device="meta")
    for fn in (probe_dot.launch, probe_dot.matvec):
        with pytest.raises(ValueError, match=match):
            fn(name, E, v)
    E = torch.empty(2, 8, 32, device="meta")
    v = torch.empty(2, 32, device="meta")
    for fn in (probe_dot.launch, probe_dot.matvec):
        with pytest.raises(ValueError, match="device"):
            fn(name, E, v)
