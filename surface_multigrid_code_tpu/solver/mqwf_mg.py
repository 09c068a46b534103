"""min_quad_with_fixed-style multigrid solver (user-facing API).

Reproduces the semantics of reference src/min_quad_with_fixed_mg.{h,cpp}:

- `min_quad_with_fixed_mg_precompute(A, mg)` (unconstrained overload,
  :3-51): sets mg[0].A = A, Galerkin-coarsens A_{l} = P_l^T A_{l-1} P_l,
  shifts the coarsest diagonal by +1e-12, caches diagonals, prefactorizes
  the coarsest level.
- `min_quad_with_fixed_mg_precompute(A, known, mg)` (constrained overload,
  :137-257): splits indices into known/unknown, slices A_uu / A_uk,
  row-slices P_full to unknown rows, prunes all-near-zero columns of P
  level by level (threshold 1e-15, keep column iff some entry > 1e-15),
  propagating the kept columns as the next level's row set, then Galerkin
  as above.
- `min_quad_with_fixed_mg_solve(...)` (:80-135 / :288-361): constrained
  path slices z0/RHS to unknowns, folds constraints RHS_u -= A_uk @ known,
  iterates up to maxIter V-cycles recording the absolute residual 2-norm
  before each cycle, stops when below tolerance, scatters unknowns+knowns
  back, returns convergence bool. Defaults tol=1e-3, maxIter=20, 2 pre +
  2 post relaxations.

Host side does the sparse slicing/Galerkin (NumPy/SciPy); the iteration
itself runs as one jitted device program (see solver/vcycle.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig
from surface_multigrid_code_tpu.solver.hierarchy import MGLevel
from surface_multigrid_code_tpu.solver.vcycle import (
    DeviceHierarchy,
    build_device_hierarchy,
    solve_loop,
    solve_loop_ir,
)


@dataclass
class MQWFData:
    """Analog of reference min_quad_with_fixed_mg_data
    (src/min_quad_with_fixed_mg.h:22-29) plus the device hierarchy."""

    n: int
    known: np.ndarray
    unknown: np.ndarray
    LHS: sp.csr_matrix
    Auk: sp.csr_matrix | None
    hier: DeviceHierarchy
    cfg: SolveConfig
    dtype: object
    colorings: list[np.ndarray] | None = None
    # finest operator in f64 for mixed-precision iterative refinement
    # (built when the hierarchy dtype is f32 and x64 is available)
    A64: object | None = None


def _default_dtype():
    import jax

    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def min_quad_with_fixed_mg_precompute(
    A: sp.spmatrix,
    known: np.ndarray | None,
    mg: list[MGLevel],
    cfg: SolveConfig = SolveConfig(),
    dtype=None,
    colorings: list[np.ndarray] | None = None,
) -> MQWFData:
    """Precompute solver data. `known=None` or empty = unconstrained overload.
    """
    dtype = dtype or _default_dtype()
    A = A.tocsr().astype(np.float64)
    n = A.shape[0]
    assert (abs(A - A.T) > 1e-10 * max(1.0, abs(A).max())).nnz == 0, (
        "input matrix must be symmetric"
    )

    if known is None or len(known) == 0:
        known = np.zeros(0, dtype=np.int64)
        unknown = np.arange(n, dtype=np.int64)
        Auk = None
        mg[0].A = A
        for lv in range(1, len(mg)):
            mg[lv].P = mg[lv].P_full.tocsr()
            mg[lv].PT = mg[lv].P.T.tocsr()
            mg[lv].A = (mg[lv].PT @ mg[lv - 1].A @ mg[lv].P).tocsr()
        LHS = A
    else:
        known = np.asarray(known, dtype=np.int64).ravel()
        unknown = np.setdiff1d(np.arange(n, dtype=np.int64), known)
        A_csr = A.tocsr()
        LHS = A_csr[unknown][:, unknown].tocsr()
        Auk = A_csr[unknown][:, known].tocsr()

        # Row-slice P_full to unknown rows; prune near-zero columns level by
        # level, propagating kept columns downward
        # (reference src/min_quad_with_fixed_mg.cpp:181-220).
        mg[1].P = mg[1].P_full.tocsr()[unknown]
        for lv in range(1, len(mg)):
            P = mg[lv].P.tocsc()
            # vectorized per-column "any entry above threshold" (the same
            # idiom as refresh.py; the previous per-column Python loop was
            # pathological at 1M-vertex scale)
            above = sp.csc_matrix(
                (P.data > cfg.prune_threshold, P.indices, P.indptr),
                shape=P.shape,
            )
            keep = np.flatnonzero(
                np.asarray(above.sum(axis=0)).ravel() > 0
            ).astype(np.int64)
            if keep.shape[0] < P.shape[1]:
                mg[lv].P = P[:, keep].tocsr()
                if lv < len(mg) - 1:
                    mg[lv + 1].P = mg[lv + 1].P_full.tocsr()[keep]
            else:
                # nothing pruned at this level: deeper levels keep P_full
                for l2 in range(lv + 1, len(mg)):
                    mg[l2].P = mg[l2].P_full.tocsr()
                break

        mg[0].A = LHS
        for lv in range(1, len(mg)):
            mg[lv].PT = mg[lv].P.T.tocsr()
            mg[lv].A = (mg[lv].PT @ mg[lv - 1].A @ mg[lv].P).tocsr()

    # coarsest diagonal shift (reference :31-36, :236-240)
    Ac = mg[-1].A.tolil()
    Ac.setdiag(Ac.diagonal() + cfg.coarsest_diag_shift)
    mg[-1].A = Ac.tocsr()
    for lv in range(len(mg)):
        mg[lv].A_diag = mg[lv].A.diagonal()

    # Row colorings for multi-color GS depend only on each level's sparsity,
    # which is static across value refreshes (e.g. MCF's per-step rebuild) —
    # compute once and let callers thread `data.colorings` back in.
    from surface_multigrid_code_tpu.config import SmootherType
    from surface_multigrid_code_tpu.ops.smoothers import greedy_coloring

    if colorings is None and cfg.smoother == SmootherType.MULTICOLOR_GS:
        colorings = [greedy_coloring(mg[lv].A) for lv in range(len(mg) - 1)]

    import jax

    As = [lvl.A for lvl in mg]
    Ps = [mg[lv].P for lv in range(1, len(mg))]
    hier = build_device_hierarchy(
        As, Ps, cfg=cfg, dtype=dtype, colorings=colorings
    )

    # Mixed-precision support (DESIGN.md "Precision policy"): keep the
    # finest operator in f64 alongside the f32 hierarchy so tight-tolerance
    # solves can run iterative refinement.  Costs one extra finest-level
    # ELL copy; skipped when the hierarchy is already f64 or x64 is off.
    from surface_multigrid_code_tpu.ops.sparse import ell_from_csr

    A64 = None
    if dtype != jnp.float64 and jax.config.jax_enable_x64:
        A64 = ell_from_csr(As[0], dtype=jnp.float64)

    return MQWFData(
        n=n,
        known=known,
        unknown=unknown,
        LHS=LHS,
        Auk=Auk,
        hier=hier,
        cfg=cfg,
        dtype=dtype,
        colorings=colorings,
        A64=A64,
    )


def min_quad_with_fixed_mg_solve(
    data: MQWFData,
    RHS: np.ndarray,
    known_val: np.ndarray | None = None,
    z0: np.ndarray | None = None,
    tolerance: float = 1e-3,
    max_iter: int = 20,
    refine: bool | None = None,
) -> tuple[np.ndarray, list[float], bool]:
    """Solve; returns (z, r_his, converged).

    Matches reference loop semantics: residual recorded before each cycle;
    converged iff the last recorded residual <= tolerance
    (src/min_quad_with_fixed_mg.cpp:330-360).

    refine: mixed-precision iterative refinement (f32 V-cycles inside an
    f64 defect-correction loop, solver/vcycle.py:solve_loop_ir).  None =
    auto: engage when the hierarchy is f32, an f64 finest operator was
    built at precompute, and the requested tolerance is below the f32
    residual floor (1e-6 x initial residual scale is unreachable in f32;
    the reference's ex04 asks for 1e-10, 04_mg_solver_nobd/main.cpp:105).
    """
    RHS = np.asarray(RHS, dtype=np.float64)
    vector_input = RHS.ndim == 1
    if z0 is None:
        z0 = np.zeros_like(RHS)
    z0 = np.asarray(z0, dtype=np.float64)
    assert z0.shape == RHS.shape

    if data.known.size:
        assert known_val is not None
        known_val = np.asarray(known_val, dtype=np.float64)
        if vector_input:
            known_val = known_val.reshape(-1)
        rhs_u = RHS[data.unknown] - (data.Auk @ known_val)
        z_u = z0[data.unknown]
    else:
        rhs_u = RHS
        z_u = z0

    from surface_multigrid_code_tpu.utils.profiler import profile_region

    if refine is None:
        init_scale = float(np.linalg.norm(rhs_u)) or 1.0
        refine = data.A64 is not None and tolerance < 1e-6 * init_scale
    if refine and data.A64 is None:
        raise ValueError(
            "refine=True but no f64 finest operator was built at precompute"
            " (hierarchy is f64 already, or x64 is disabled)"
        )

    with profile_region("MG: total VCycle", trace=True):
        if refine:
            z_dev, r_his_dev, k = solve_loop_ir(
                data.hier,
                data.A64,
                jnp.asarray(rhs_u, dtype=jnp.float64),
                jnp.asarray(z_u, dtype=jnp.float64),
                jnp.asarray(float(tolerance), dtype=jnp.float64),
                int(max_iter),
                data.cfg,
            )
        else:
            z_dev, r_his_dev, k = solve_loop(
                data.hier,
                jnp.asarray(rhs_u, dtype=data.dtype),
                jnp.asarray(z_u, dtype=data.dtype),
                jnp.asarray(float(tolerance), dtype=data.dtype),
                int(max_iter),
                data.cfg,
            )
        z_dev.block_until_ready()
    z_u = np.asarray(z_dev, dtype=np.float64)
    k = int(k)
    r_his = [float(r) for r in np.asarray(r_his_dev)[:k]]
    converged = bool(r_his and r_his[-1] <= tolerance)

    if data.known.size:
        z = np.empty_like(z0)
        z[data.unknown] = z_u
        z[data.known] = known_val
    else:
        z = z_u
    return z, r_his, converged
