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

P2's kernel runs its product on the TF32 tensor cores in three passes;
``tf32_rna`` emulates the card's rounding on the bits, so the accuracy
argument for three passes (and against one) is checked here.
"""

import ast
import ctypes
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lpbox_admm_tpu_torch.kernels import build
from lpbox_admm_tpu_torch.scripts import probe_ab, probe_dot

from torch_port_util import tf32_rna

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


@pytest.mark.parametrize("shape", [(2, 8, 30), (2, 8, 12292), (3, 5, 1),
                                   (70000, 2, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_batched_dot_takes_any_n(shape):
    """P1 takes every shape the JAX ``k_batched`` takes: n % 4 != 0, n
    past the 12 288 floats of v its first design kept in shared memory,
    n = 1, bt past the 65 535 blocks of a grid's y dimension.  The port
    against the JAX kernel in interpret mode."""
    bt, m, n = shape
    E, v = probe_dot.make_inputs(bt, m, n, seed=n)
    probe_dot.check_shapes("batched_dot", torch.from_numpy(E),
                           torch.from_numpy(v))
    want = np.einsum("bmn,bn->bm", E.astype(np.float64), v.astype(np.float64))
    tol = 1e-5 * np.abs(want).max()
    yj = np.asarray(pl.pallas_call(
        jax_kernel("k_batched", bt, m, n),
        out_shape=jax.ShapeDtypeStruct((bt, m), jnp.float32),
        interpret=True)(jnp.asarray(E), jnp.asarray(v)))
    yt = probe_dot.matvec("batched_dot", torch.from_numpy(E),
                          torch.from_numpy(v)).numpy()
    assert np.abs(yt - want).max() <= tol
    assert np.abs(yt - yj).max() <= tol


def test_batched_dot_takes_any_bt():
    """P1 has no limit on bt: it takes 70 000 instances, which P3 (the
    instance on grid.y) and P2 (8 n-tiles of 8 vectors) refuse; on a
    device other than CUDA it is refused as a launch."""
    E = torch.empty(70000, 2, 8, device="meta")
    v = torch.empty(70000, 8, device="meta")
    probe_dot.check_shapes("batched_dot", E, v)
    with pytest.raises(ValueError, match="over 65535"):
        probe_dot.check_shapes("vpu", E, v)
    with pytest.raises(ValueError, match="over 64"):
        probe_dot.check_shapes("pairs", E, v)
    with pytest.raises(ValueError, match="device"):
        probe_dot.launch("batched_dot", E, v)


def test_probe_ab_reads_p1_registers():
    """The A/B script keeps ptxas's register count of each P1 instance
    and nothing of the other kernels; without a card it does nothing."""
    text = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120probe_batched_kernelILb1EEEvNS_9ProbeArgsE' for 'sm_90a'
ptxas info    : Used 115 registers, used 0 barriers, 49248 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116probe_vpu_kernelILb1EEEvNS_9ProbeArgsE' for 'sm_90a'
ptxas info    : Used 40 registers
"""
    assert probe_ab.ptxas_registers(text) == {
        "_ZN12_GLOBAL__N_120probe_batched_kernelILb1EEEvNS_9ProbeArgsE": 115}
    if not torch.cuda.is_available():
        assert probe_ab.main([]) == 1


@pytest.mark.parametrize("name,shape,match", [
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


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                      # TF32's spacing at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                  1 + 3 * ulp / 2, 3.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0], np.float32)
    assert np.array_equal(tf32_rna(x), want)
    a = np.random.RandomState(0).randn(4096).astype(np.float32)
    hi = tf32_rna(a)
    lo = tf32_rna(a - hi)
    for t in (hi, lo):
        assert not (t.view(np.uint32) & np.uint32(0x1FFF)).any()
    # a - hi is exact in f32; lo keeps 11 of its bits
    assert np.all(np.abs(a - hi) <= np.abs(a) * 2.0 ** -11)
    assert np.all(np.abs(a.astype(np.float64) - hi - lo)
                  <= np.abs(a) * 2.0 ** -21)


@pytest.mark.parametrize("shape", [(8, 256, 256), (3, 10, 260), (64, 16, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pairs_needs_three_tf32_passes(shape):
    """P2's product on the TF32 tensor cores: one pass (both operands
    rounded to TF32) misses 1e-5 of max |ref| (6.0e-5 at the probe's
    shape); hi*hi + hi*lo + lo*hi stays three orders under it (1.4e-8).
    Products of TF32 values are exact in f64, so this is the rounding
    of the operands alone; the card's f32 accumulation adds what P1's
    f32 sums add."""
    E, v = probe_dot.make_inputs(*shape)
    f64 = lambda a, b: np.einsum("bmn,bn->bm", a.astype(np.float64),
                                 b.astype(np.float64))
    want = f64(E, v)
    scale = np.abs(want).max()
    Eh, vh = tf32_rna(E), tf32_rna(v)
    El, vl = tf32_rna(E - Eh), tf32_rna(v - vh)
    one = np.abs(f64(Eh, vh) - want).max() / scale
    three = np.abs(f64(El, vh) + f64(Eh, vl) + f64(Eh, vh) - want).max() \
        / scale
    assert one > probe_dot.TOL
    assert three <= probe_dot.TOL / 100


class _SizeLib:
    """Stands in for the kernel library: a struct-size entry point that
    counts its calls."""

    def __init__(self, size):
        self.size, self.calls = size, 0

    def lpbox_probe_args_size(self):
        self.calls += 1
        return self.size


def test_check_struct_asks_the_library_once():
    ok = _SizeLib(ctypes.sizeof(probe_dot._Args))
    for _ in range(3):
        build.check_struct(ok, "lpbox_probe_args_size", probe_dot._Args)
    assert ok.calls == 1
    bad = _SizeLib(ctypes.sizeof(probe_dot._Args) + 8)
    for calls in (1, 2):     # a refusal is not remembered: it stays one
        with pytest.raises(RuntimeError, match="the C struct"):
            build.check_struct(bad, "lpbox_probe_args_size", probe_dot._Args)
        assert bad.calls == calls
