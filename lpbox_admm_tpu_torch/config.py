"""Solver and policy configuration.

The port's own copy of the JAX package's ``config.py`` (only
``dataclasses`` is needed, but the port imports nothing of that
package): the same fields, the same defaults and the same ``replace``,
so that one set of field values drives both packages in the tests.

Provenance of the presets (reference SCLBD/Accelerated-Lpbox-ADMM):
LP preset  -> LinerProgramming/.../cython_solver/LPboxADMMsolver.cpp:489-507.
Seg preset -> Segmentation/.../cython/src/LPboxADMMsolver.cpp:658-672.
Attack preset -> SparseAttack/SparseAttack/flags.py:83-157.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Hyperparameters of the Lp-Box ADMM iteration."""

    # Convergence
    stop_threshold: float = 1e-4     # ||x-y1||/||x|| and ||x-y2||/||x||
    std_threshold: float = 1e-12     # relative std of recent objectives
    history_size: int = 10           # objective history window for std stop
    max_iters: int = 20_000

    # Penalty schedule
    initial_rho: float = 25.0
    learning_fact: float = 1.01      # rho multiplier every rho_change_step
    rho_change_step: int = 25
    rho_upper_limit: Optional[float] = None

    # Over-relaxation of the dual ascent
    gamma0: float = 1.6
    gamma_factor: float = 0.95       # gamma <- max(gamma*factor, 1) on rho step

    # x-update linear solve: Jacobi PCG (every solver) or the exact
    # Woodbury solve (core.lp only)
    pcg_tol: float = 1e-3
    pcg_maxiters: int = 1000
    linsolve: str = "cg"             # "cg" | "woodbury"

    projection_lp: int = 2

    # Rule-based early fixing
    fix_threshold: float = 1e-3
    consistency: int = 5
    min_fix: int = 10                # fixes <= min_fix in a round are ignored

    # Track the best rounding that satisfies the reduced constraints
    # (one extra E pass per sampled iteration).
    feasible_incumbent: bool = True
    # Sample the incumbent only every this-many iterations.
    incumbent_stride: int = 1

    dtype: str = "float32"
    # Storage type of E inside the fused window kernel: "bfloat16" is
    # exact for 0/1 constraint matrices and halves E's bytes.
    matvec_dtype: str = "float32"
    ginv_dtype: str = "float32"
    ginv_apply: str = "dense"

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


#: Combinatorial-auction LP preset (reference LPboxADMMsolver.cpp:489-507).
LP_CONFIG = SolverConfig()

#: Image-segmentation BQP preset (Seg LPboxADMMsolver.cpp:658-672): CG
#: x-update, rho 5 x 1.03 every 5 iterations up to 1000, stop at 1e-3.
SEG_CONFIG = SolverConfig(
    stop_threshold=1e-3,
    std_threshold=1e-6,
    history_size=5,
    max_iters=10_000,
    initial_rho=5.0,
    learning_fact=1.03,
    rho_change_step=5,
    rho_upper_limit=1000.0,
    gamma0=1.0,
    gamma_factor=0.99,
    linsolve="cg",
)


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Sparse adversarial attack hyperparameters.

    Reproduces the effective defaults of the reference's ``flags.py``
    (SparseAttack/SparseAttack/flags.py:83-157).
    """

    k: int = 200                     # L0 budget (number of perturbed entries)
    lambda1: float = 1e-3            # CNN-loss weight
    lambda2: float = 1e-3            # group-sparsity weight
    confidence: float = 0.0          # CW margin
    loss: str = "cw"                 # "cw" | "ce"
    categories: int = 10

    lr_g: float = 0.1
    lr_e: float = 0.1
    lr_min: float = 1e-3
    lr_decay_step: int = 50
    lr_decay_factor: float = 0.9

    rho1: float = 5e-3
    rho2: float = 5e-3
    rho3: float = 5e-3
    rho4: float = 1e-4
    rho_increase_step: int = 1
    rho_increase_factor: float = 1.01
    rho1_max: float = 20.0
    rho2_max: float = 20.0
    rho3_max: float = 100.0
    rho4_max: float = 0.01

    maxIter_e: int = 2000
    maxIter_g: int = 2000
    maxIter_mm: int = 1

    min_pix_value: float = 0.0
    max_pix_value: float = 1.0
    segments: int = 150              # SLIC superpixel target count

    init_lambda1: float = 1e-3
    lambda1_search_times: int = 6
    lambda1_upper_bound: float = 1e2
    lambda1_lower_bound: float = 0.0

    def replace(self, **kw) -> "AttackConfig":
        return dataclasses.replace(self, **kw)


ATTACK_CONFIG = AttackConfig()


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Early-fixing policy network and fixing-rule hyperparameters
    (reference mha.py / cmd_args.py presets)."""

    net: str = "mha"                 # "mha" | "mlp"
    embed_dim: int = 128
    n_heads: int = 8
    n_layers: int = 2
    feed_forward_hidden: int = 512
    pe_dim: int = 5                  # positional-encoding dim appended to input
    chunk_dim: int = 5               # trajectory chunk feature width
    node_size: int = 20              # tokens per variable (20 LP / 5 Seg)
    window_mode: str = "chunk"       # "chunk" (LP reshape) | "sliding" (Seg)
    fix_confidence: float = 0.9      # C: fix to 1 if sigma>C, to 0 if sigma<1-C
    # consecutive windows a variable must clear the bar (same side)
    fix_windows: int = 1
    # 0 off; 1 endpoint gate; 2 endpoint + stability gate
    fix_agree_gate: int = 0
    # confidence margin shrinks with the bid's |b| rank:
    # margin_j = (1 - C) * (1 - damage_gate * r_j)
    damage_gate: float = 0.0
    damage_rank_floor: float = 0.0
    # seg QP only: the margin of every pixel within boundary_band
    # 8-neighbour hops of a label change of the window-end rounding is
    # scaled by (1 - boundary_gate); band 1 = the boundary pixels only,
    # <= 0 disables the gate
    boundary_gate: float = 0.0
    boundary_band: int = 2
    # seg QP only, masked path: at each fix event also fix every pixel
    # with |x - 0.5| > traj_fix_thr to round(x); traj_fix_only ignores
    # the policy; traj_fix_windows > 0 limits it to the first k events
    traj_fix_thr: float = 0.0
    traj_fix_only: bool = False
    traj_fix_windows: int = 0
    ensemble_veto: float = 0.5
    lr: float = 1e-4
    lr_decay_step: int = 2000
    lr_decay_factor: float = 0.5
    num_epochs: int = 20
    seed: int = 19260817

    def replace(self, **kw) -> "PolicyConfig":
        return dataclasses.replace(self, **kw)
