"""RefreshableMGSolver: device value-refresh path vs the full precompute."""

import numpy as np
import pytest

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
from surface_multigrid_code_tpu.solver.mqwf_mg import (
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)
from surface_multigrid_code_tpu.solver.refresh import RefreshableMGSolver
from surface_multigrid_code_tpu.utils.synthetic import icosphere


@pytest.fixture(scope="module")
def setup():
    V, F = icosphere(3)
    mg = mg_precompute(V, F, min_coarsest_nv=60, verbose=False)
    L = cotmatrix(V, F)
    M = massmatrix(V, F)
    rhs = np.asarray(M @ V[:, 0])
    return V, F, mg, L, M, rhs


@pytest.mark.parametrize(
    "smoother",
    [SmootherType.JACOBI, SmootherType.MULTICOLOR_GS, SmootherType.CHEBYSHEV],
)
def test_refresh_solver_converges(setup, smoother):
    V, F, mg, L, M, rhs = setup
    A = (M - 0.01 * L).tocsr()
    A.sum_duplicates()
    cfg = SolveConfig(smoother=smoother)
    solver = RefreshableMGSolver(mg, A, cfg=cfg, dtype=jnp.float64)
    z, r_his, ok = solver.solve(A.data, rhs, tolerance=1e-10, max_iter=40)
    assert ok
    assert np.linalg.norm(A @ z - rhs) < 1e-9


def test_refresh_matches_full_precompute(setup):
    V, F, mg, L, M, rhs = setup
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    pattern = (M - 0.01 * L).tocsr()
    pattern.sum_duplicates()
    solver = RefreshableMGSolver(mg, pattern, cfg=cfg, dtype=jnp.float64)
    for delta in (0.01, 0.05):
        A = (M - delta * L).tocsr()
        A.sum_duplicates()
        z1, r1, _ = solver.solve(A.data, rhs, tolerance=1e-8, max_iter=30)
        data = min_quad_with_fixed_mg_precompute(
            A, None, mg, cfg=cfg, dtype=jnp.float64
        )
        z2, r2, _ = min_quad_with_fixed_mg_solve(
            data, rhs, tolerance=1e-8, max_iter=30
        )
        assert len(r1) == len(r2)
        np.testing.assert_allclose(r1, r2, rtol=1e-6)
        np.testing.assert_allclose(z1, z2, rtol=1e-6, atol=1e-10)
