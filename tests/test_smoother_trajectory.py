"""Smoother-trajectory parity adjudication (SURVEY.md §7 hard part 3).

The reference smoother is sequential forward Gauss-Seidel; the device
default is multicolor-GS.  `SequentialGSReference` reproduces the
reference V-cycle trajectory exactly (same hierarchy, 2+2 schedule,
prefactorized coarse solve, reference loop semantics), so we can assert
how the device trajectories compare at the reference tolerances.  The
accepted-divergence decision is documented in DESIGN.md "Smoothers":
multicolor-GS must converge within +1 V-cycle of sequential GS on the
reference problem class (it typically matches exactly).
"""

import numpy as np
import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
from surface_multigrid_code_tpu.solver.host_reference import (
    SequentialGSReference,
)
from surface_multigrid_code_tpu.solver.mqwf_mg import (
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)
from surface_multigrid_code_tpu.utils.synthetic import icosphere


def _setup(tol):
    V, F = icosphere(4)
    mg = mg_precompute(V, F, min_coarsest_nv=120, verbose=False)
    A = (-cotmatrix(V, F)).tocsr()
    n = A.shape[0]
    rng = np.random.default_rng(0)
    known = np.sort(rng.choice(n, size=12, replace=False))
    B = np.asarray(massmatrix(V, F) @ np.ones(n))
    B[known] = 0.0
    z0 = rng.uniform(-1, 1, n)
    return mg, A, known, B, z0


def test_multicolor_gs_within_one_cycle_of_sequential_gs():
    tol = 1e-10
    mg, A, known, B, z0 = _setup(tol)
    cfg = SolveConfig(smoother=SmootherType.MULTICOLOR_GS)
    data = min_quad_with_fixed_mg_precompute(
        A, known, mg, cfg=cfg, dtype=jnp.float64
    )
    # the reference-trajectory mirror runs on the SAME pruned hierarchy
    ref = SequentialGSReference(
        [lvl.A for lvl in mg], [mg[lv].P for lv in range(1, len(mg))]
    )
    rhs = B[data.unknown] - data.Auk @ np.zeros(known.size)
    z_ref, r_ref, ok_ref = ref.solve(
        rhs, z0=z0[data.unknown], tolerance=tol, max_iter=40
    )
    z, r_dev, ok_dev = min_quad_with_fixed_mg_solve(
        data, B, known_val=np.zeros(known.size), z0=z0,
        tolerance=tol, max_iter=40,
    )
    assert ok_ref and ok_dev, (r_ref, r_dev)
    # accepted-divergence criterion: within +1 cycle of the reference
    assert len(r_dev) <= len(r_ref) + 1, (len(r_dev), len(r_ref))
    # and both are multigrid-grade trajectories (median rate < 0.25)
    rate_ref = np.median(np.array(r_ref[1:]) / np.array(r_ref[:-1]))
    rate_dev = np.median(np.array(r_dev[1:]) / np.array(r_dev[:-1]))
    assert rate_ref < 0.25 and rate_dev < 0.25, (rate_ref, rate_dev)


def test_sequential_reference_matches_direct_solution():
    # sanity: the host mirror solves the same system as scipy direct
    import scipy.sparse as sp

    tol = 1e-12
    mg, A, known, B, z0 = _setup(tol)
    data = min_quad_with_fixed_mg_precompute(A, known, mg, dtype=jnp.float64)
    ref = SequentialGSReference(
        [lvl.A for lvl in mg], [mg[lv].P for lv in range(1, len(mg))]
    )
    rhs = B[data.unknown]
    z_ref, r_ref, ok = ref.solve(rhs, tolerance=tol, max_iter=60)
    z_direct = sp.linalg.spsolve(data.LHS.tocsc(), rhs)
    assert ok
    assert np.abs(z_ref - z_direct).max() < 1e-9 * max(
        1.0, np.abs(z_direct).max()
    )
