"""The plain ELL path against f64 host references, for every smoother.

Each case solves through the public entry points
(min_quad_with_fixed_mg_precompute / _solve) and checks the solution
against scipy's direct solve of the same (reduced) system, and the
device residual history against the host residual of each iterate's
endpoint.  For multicolor GS it also applies the trajectory-parity
criterion against the sequential-GS mirror (solver/host_reference.py).
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

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


@pytest.fixture(scope="module")
def sphere():
    V, F = icosphere(3)
    M = massmatrix(V, F)
    A = (M - 0.01 * cotmatrix(V, F)).tocsr()
    return V, F, M, A


@pytest.mark.parametrize("nrhs", [1, 3])
@pytest.mark.parametrize("pinned", [False, True],
                         ids=["unconstrained", "pinned"])
@pytest.mark.parametrize(
    "smoother",
    [SmootherType.JACOBI, SmootherType.CHEBYSHEV,
     SmootherType.MULTICOLOR_GS],
)
def test_plain_path_matches_host_reference(sphere, smoother, pinned, nrhs):
    V, F, M, A = sphere
    n = V.shape[0]
    rng = np.random.default_rng(0)
    mg = mg_precompute(V, F, min_coarsest_nv=80, verbose=False)
    known = np.sort(rng.choice(n, size=12, replace=False)) if pinned else None
    B = np.asarray(M @ V[:, :nrhs]) if nrhs > 1 else np.asarray(M @ V[:, 0])
    kv = rng.standard_normal((12, nrhs) if nrhs > 1 else 12) if pinned \
        else None
    cfg = SolveConfig(smoother=smoother)
    data = min_quad_with_fixed_mg_precompute(
        A, known, mg, cfg=cfg, dtype=jnp.float64)
    rhs_u = B[data.unknown] - (data.Auk @ kv if pinned else 0.0)
    tol = 1e-10 * float(np.linalg.norm(rhs_u))
    z, r_his, ok = min_quad_with_fixed_mg_solve(
        data, B, known_val=kv, tolerance=tol, max_iter=60)
    assert ok, r_his

    lu = spla.splu(data.LHS.tocsc())
    z_ref = lu.solve(rhs_u)
    z_u = z[data.unknown]
    assert np.linalg.norm(z_u - z_ref) <= 1e-8 * np.linalg.norm(z_ref)
    if pinned:
        np.testing.assert_array_equal(z[data.known], kv)
    # the recorded residual is the f64 host residual of the returned z
    host = np.linalg.norm(rhs_u - data.LHS @ z_u)
    assert abs(host - r_his[-1]) <= 1e-6 * host + 1e-14
    # multigrid-grade convergence for every smoother
    rates = np.array(r_his[1:]) / np.array(r_his[:-1])
    assert np.median(rates) < 0.5, rates

    if smoother == SmootherType.MULTICOLOR_GS:
        ref = SequentialGSReference(
            [lvl.A for lvl in mg], [mg[lv].P for lv in range(1, len(mg))]
        )
        _, r_ref, ok_ref = ref.solve(rhs_u, tolerance=tol, max_iter=60)
        assert ok_ref
        assert len(r_his) <= len(r_ref) + 1, (len(r_his), len(r_ref))
