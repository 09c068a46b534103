"""Hand-scheduled halo exchange (parallel/halo.py) against the GSPMD path
(parallel/spmd.py): identical residual histories over 2, 4 and 8 virtual
devices, for one and several right-hand sides, Jacobi and Chebyshev.

Both run with the natural row order (reorder=False) so the float sums
nearly match; the Chebyshev bounds come from the same host estimate."""

import numpy as np
import pytest

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.parallel.halo import HaloHierarchy
from surface_multigrid_code_tpu.parallel.spmd import (
    build_sharded_hierarchy,
    make_row_mesh,
    sharded_solve,
)
from surface_multigrid_code_tpu.utils.synthetic import subdivision_hierarchy


@pytest.fixture(scope="module")
def system():
    meshes, Ps = subdivision_hierarchy(4)
    V, F = meshes[0]
    M = massmatrix(V, F)
    A = (M - 0.01 * cotmatrix(V, F)).tocsr()
    As = [A]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    return As, Ps, np.asarray(M @ V)


@pytest.mark.parametrize(
    "smoother", [SmootherType.JACOBI, SmootherType.CHEBYSHEV])
@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_halo_matches_spmd(system, ndev, ncols, smoother):
    As, Ps, rhs3 = system
    rhs = rhs3[:, 0] if ncols == 1 else rhs3
    mesh = make_row_mesh(ndev)
    cfg = SolveConfig(smoother=smoother)
    halo = HaloHierarchy(As, Ps, mesh, cfg=cfg, dtype=jnp.float64,
                         reorder=False)
    z1, r1, _ = halo.solve(rhs, tolerance=0.0, max_iter=6)
    hier, sizes = build_sharded_hierarchy(As, Ps, mesh, cfg=cfg,
                                          dtype=jnp.float64)
    z2, r2, k = sharded_solve(hier, sizes, mesh, rhs, tolerance=0.0,
                              max_iter=6, cfg=cfg, dtype=jnp.float64)
    assert len(r1) == len(r2) == 6
    assert r1[-1] < 1e-3 * r1[0], r1  # both actually converge
    # f64 sums in another order: last digits may differ once the residual
    # is down at 1e-8 of its start
    np.testing.assert_allclose(r1, r2, rtol=1e-9, atol=1e-12 * r1[0])
    np.testing.assert_allclose(z1, z2, rtol=1e-8, atol=1e-12)
