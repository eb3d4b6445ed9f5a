"""lpbox_admm_tpu_torch: the PyTorch/CUDA port of lpbox_admm_tpu.

Batched Lp-Box ADMM for binary LPs, grid segmentation QPs and general
eq/ineq binary QPs with learned early fixing, written
in PyTorch for one NVIDIA H100.  The two hot kernels -- the fused LP
ADMM window and the policy forward -- are hand-written CUDA C++
(``csrc/``), built with one ``nvcc`` call into a shared library that
``kernels/build.py`` loads with ctypes.  Every kernel wrapper runs the
kernel on CUDA tensors and its plain PyTorch version on CPU tensors.

Entry points run on the card unless the caller asks for the CPU:
``adapters.ca.make_problem(..., device="cuda")`` and
``adapters.segmentation.make_problem(..., device="cuda")`` are the
defaults and the solvers follow their tensors' device.
"""

from .config import LP_CONFIG, SEG_CONFIG, PolicyConfig, SolverConfig

__all__ = ["SolverConfig", "PolicyConfig", "LP_CONFIG", "SEG_CONFIG"]
