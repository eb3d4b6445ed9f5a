"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and one more ``nvcc`` call links the objects into one
shared library with a plain C interface, loaded with ctypes.  No
PyTorch headers are included, so the build takes seconds.  The library
lands in ``lpbox_admm_tpu_torch/_build/`` (git-ignored) under a name
that carries the hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  ``nvcc`` comes from
``$CUDA_HOME/bin`` or ``PATH``; without it the build raises.

Processes that start together (the ranks of ``parallel.mesh``) build
once: a process that finds the library missing takes an exclusive lock
on a file beside it (``flock``, released by the kernel if the holder
dies) and builds only if the library is still missing once it holds
the lock; the others wait on the lock and load what it built.  The
data-parallel entry points build in the parent before they start the
ranks.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

#: what the last build in this process did: seconds, command, ptxas report
BUILD_INFO: Dict[str, object] = {}


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found in $CUDA_HOME/bin or PATH: the CUDA kernels of "
            "lpbox_admm_tpu_torch are built from csrc/ with nvcc")
    return found


#: how long a process waits for another one's build
LOCK_WAIT_S = 1200


def build() -> Path:
    """Compile all kernels into one library (skipped when a library of
    the same source hash exists); returns its path."""
    lib = BUILD_DIR / f"liblpbox_kernels_{source_hash()}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(lib.with_name(lib.name + ".lock"), "w") as lock:
            t0 = time.monotonic()
            while True:
                try:
                    fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except BlockingIOError:
                    if time.monotonic() - t0 > LOCK_WAIT_S:
                        raise RuntimeError(
                            f"waited {LOCK_WAIT_S} s for another process's "
                            f"build of {lib.name}")
                    time.sleep(0.2)
            try:
                if not lib.exists():
                    return _compile(lib)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    if BUILD_INFO.get("path") != str(lib):   # built by another process
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True)
    return lib


def _compile(lib: Path) -> Path:
    """Build ``lib`` with nvcc (the caller holds the build lock)."""
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    tmp = lib.with_name(f"{lib.name}.{tag}")
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    cmds = [[nvcc, *COMPILE_FLAGS, "-I", str(SRC_DIR), "-c", "-o", str(o),
             str(src)] for src, o in zip(sources(), objs)]
    cmds.append([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds[:-1]]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
        results = [(c, p.returncode, out, err)
                   for c, p, (out, err) in zip(cmds, procs, outs)]
        if all(rc == 0 for _, rc, _, _ in results):
            res = subprocess.run(cmds[-1], capture_output=True, text=True,
                                 timeout=300)
            results.append((cmds[-1], res.returncode, res.stdout,
                            res.stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for o in objs:
            o.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    for c, rc, out, err in results:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(c)}\n"
                               f"{out}\n{err}")
    os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=secs, cached=False,
                      command="\n".join(" ".join(c) for c in cmds),
                      ptxas="".join(err for _, _, _, err in results))
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set.
    Each launcher takes a pointer to its argument struct and the CUDA
    stream, and returns the ``cudaError_t`` of the launch."""
    lib = ctypes.CDLL(str(build()))
    for name in ("lpbox_lp_window", "lpbox_policy_forward",
                 "lpbox_stream_sweep", "lpbox_symm_matvec",
                 "lpbox_probe_batched", "lpbox_probe_pairs",
                 "lpbox_probe_vpu"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("lpbox_lp_window_args_size", "lpbox_policy_args_size",
                 "lpbox_stream_sweep_args_size", "lpbox_symm_args_size",
                 "lpbox_probe_args_size"):
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
    for name in ("lpbox_stream_sweep_smem", "lpbox_lp_window_max_clusters"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    lib.lpbox_error_string.argtypes = [ctypes.c_int]
    lib.lpbox_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.lpbox_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


#: (library, size function, struct) triples whose sizes agreed
_STRUCTS_CHECKED = set()


def check_struct(lib: ctypes.CDLL, size_fn: str, struct) -> None:
    """Refuse to launch if the ctypes mirror of an argument struct does
    not have the C struct's size.  A pair that agreed is not asked again:
    ``library()`` loads one library per process, so the sizes cannot
    change, and a launch saves the ctypes call."""
    key = (lib, size_fn, struct)
    if key in _STRUCTS_CHECKED:
        return
    want = getattr(lib, size_fn)()
    if ctypes.sizeof(struct) != want:
        raise RuntimeError(f"{struct.__name__} is {ctypes.sizeof(struct)} "
                           f"bytes, the C struct {want}")
    _STRUCTS_CHECKED.add(key)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
