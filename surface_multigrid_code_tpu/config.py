"""Typed configuration for the surface multigrid framework.

The reference hardcodes all knobs at call sites (see SURVEY.md §5.6); we
centralize them here with the exact reference defaults:

- coarsening ratio 0.25, min coarsest #V 500, midpoint decimation
  (reference src/mg_precompute.cpp:94,104-105)
- solver tolerance 1e-3, maxIter 20 V-cycles, 2 pre + 2 post relaxations
  (reference src/min_quad_with_fixed_mg.cpp:63,77,324-325)
- coarsest diagonal shift 1e-12 (reference src/min_quad_with_fixed_mg.cpp:35,240)
- P column-prune threshold 1e-15 (reference src/min_quad_with_fixed_mg.cpp:197)
- joint-LSCM validity gates: 3D tri quality 0.3, UV quality 0.01, signed-area
  flip epsilon 1e-10, 2*pi fold-over slack 1e-10
  (reference src/joint_lscm.cpp:94,420,284,359)
"""

from __future__ import annotations

import dataclasses
import enum
import math


class DecimationType(enum.IntEnum):
    """Decimation variant; integer values match the reference dec_type.

    Reference src/SSP_decimate.cpp:25-38.
    """

    QSLIM = 0
    MIDPOINT = 1
    VERTEX_REMOVAL = 2


class SmootherType(str, enum.Enum):
    """Smoother for the V-cycle relaxation steps.

    The reference uses sequential in-place Gauss-Seidel
    (src/mg_VCycle.cpp:146-177). The data-parallel equivalents are
    multi-color Gauss-Seidel (same trajectory family, parallel within a
    color) or damped Jacobi.
    """

    MULTICOLOR_GS = "multicolor_gs"
    JACOBI = "jacobi"
    CHEBYSHEV = "chebyshev"


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Hierarchy construction knobs (reference src/mg_precompute.cpp:94-105)."""

    coarsening_ratio: float = 0.25
    min_coarsest_nv: int = 500
    dec_type: DecimationType = DecimationType.MIDPOINT
    # Random variants: pop a random edge among the top 1+rand()%100 heap
    # entries (reference src/SSP_random_collapse_edge.cpp:408-431).
    random_top_k: int = 100


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """V-cycle solve knobs (reference src/min_quad_with_fixed_mg.cpp:63-77)."""

    tolerance: float = 1e-3
    max_iter: int = 20
    pre_relax_iter: int = 2
    post_relax_iter: int = 2
    smoother: SmootherType = SmootherType.MULTICOLOR_GS
    jacobi_weight: float = 2.0 / 3.0
    coarsest_diag_shift: float = 1e-12
    prune_threshold: float = 1e-15
    # Chebyshev lam_max power-iteration count in refreshed solvers
    # (solver/bsr.py; 12 + 1.1x margin is the validated default — the
    # knob exists for A/B experiments, NOT production tuning: an
    # underestimated bound diverges the smoother window).
    lam_power_iters: int = 12


@dataclasses.dataclass(frozen=True)
class LSCMConfig:
    """Joint-LSCM validity gates (reference src/joint_lscm.cpp)."""

    tri_quality_3d_min: float = 0.3      # :94   boundary-case 3D gate
    tri_quality_uv_min: float = 0.01     # :420  UV quality gate
    flip_eps: float = 1e-10              # :284  signed-area flip epsilon
    foldover_slack: float = 1e-10        # :359  angle-sum > 2*pi + slack
    two_pi: float = 2.0 * math.pi


DEFAULT_MG = MGConfig()
DEFAULT_SOLVE = SolveConfig()
DEFAULT_LSCM = LSCMConfig()
