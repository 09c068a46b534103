"""min_quad_with_fixed_mg: constrained + multi-column RHS combination
(the reference's MatrixXd template instantiation,
src/min_quad_with_fixed_mg.cpp:363-373), nonzero constraint values, and
hierarchy reuse across precomputes (reference :43-49 seeding)."""

import numpy as np
import scipy.sparse as sp

from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
from surface_multigrid_code_tpu.solver.mqwf_mg import (
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)
from surface_multigrid_code_tpu.utils.synthetic import icosphere


def test_constrained_multicolumn_rhs():
    V, F = icosphere(3)
    mg = mg_precompute(V, F, min_coarsest_nv=80, verbose=False)
    A = (-cotmatrix(V, F)).tocsr()
    n = A.shape[0]
    rng = np.random.default_rng(3)
    known = np.sort(rng.choice(n, size=15, replace=False))
    known_val = rng.normal(size=(15, 3))
    M = massmatrix(V, F)
    RHS = np.asarray(M @ V)  # 3 columns
    data = min_quad_with_fixed_mg_precompute(A, known, mg)
    z, r_his, ok = min_quad_with_fixed_mg_solve(
        data, RHS, known_val=known_val, tolerance=1e-10, max_iter=40
    )
    assert ok
    np.testing.assert_allclose(z[known], known_val)
    # direct reference on unknowns
    unknown = np.setdiff1d(np.arange(n), known)
    Auu = A[unknown][:, unknown]
    Auk = A[unknown][:, known]
    rhs_u = RHS[unknown] - Auk @ known_val
    z_ref = sp.linalg.spsolve(Auu.tocsc(), rhs_u)
    np.testing.assert_allclose(z[unknown], z_ref, atol=1e-7)


def test_hierarchy_reused_across_precomputes():
    """The P stack must survive repeated precomputes with different
    matrices and constraint sets (MCF/balloon reuse pattern; the
    constrained path prunes P columns per solve)."""
    V, F = icosphere(3)
    mg = mg_precompute(V, F, min_coarsest_nv=80, verbose=False)
    L = cotmatrix(V, F)
    M = massmatrix(V, F)
    rng = np.random.default_rng(0)
    b = np.asarray(M @ np.ones(V.shape[0]))
    for it, (known, delta) in enumerate(
        [(np.array([0]), 0.01), (np.arange(5), 0.02), (None, 0.05)]
    ):
        A = (M - delta * L).tocsr() if known is None else (-L).tocsr()
        data = min_quad_with_fixed_mg_precompute(A, known, mg)
        kv = None if known is None else np.zeros(len(known))
        rhs = b.copy()
        if known is not None:
            rhs[known] = 0.0
        z, r_his, ok = min_quad_with_fixed_mg_solve(
            data, rhs, known_val=kv, tolerance=1e-8, max_iter=40
        )
        assert ok, (it, r_his)


def test_heavy_constraint_pruning():
    """Half the mesh constrained: P columns prune aggressively level by
    level (reference src/min_quad_with_fixed_mg.cpp:181-220) and the
    constrained solve still matches a sparse direct solve."""
    V, F = icosphere(3)
    mg = mg_precompute(V, F, min_coarsest_nv=80, verbose=False)
    n = V.shape[0]
    rng = np.random.default_rng(11)
    known = np.sort(rng.choice(n, size=n // 2, replace=False))
    kv = rng.normal(size=known.shape[0])
    A = (-sp.csr_matrix(cotmatrix(V, F))).tocsr()
    M = massmatrix(V, F)
    rhs = np.asarray(M @ np.ones(n))
    data = min_quad_with_fixed_mg_precompute(A, known, mg)
    # pruning actually happened: coarser P narrower than P_full
    assert mg[1].P.shape[1] < mg[1].P_full.shape[1]
    assert mg[1].P.shape[0] == n - known.shape[0]
    z, r_his, ok = min_quad_with_fixed_mg_solve(
        data, rhs, known_val=kv, tolerance=1e-10, max_iter=60
    )
    assert ok, r_his
    unknown = np.setdiff1d(np.arange(n), known)
    z_ref = sp.linalg.spsolve(
        A[unknown][:, unknown].tocsc(),
        rhs[unknown] - A[unknown][:, known] @ kv,
    )
    np.testing.assert_allclose(z[unknown], z_ref, atol=1e-7)


def test_iterative_refinement_f32_reaches_f64_tolerances():
    # the mixed precision policy (DESIGN.md): f32 V-cycle hierarchy + f64
    # defect correction must reach tolerances far below the f32 floor
    import jax.numpy as jnp

    V, F = icosphere(3)
    mg = mg_precompute(V, F, min_coarsest_nv=80, verbose=False)
    A = (-cotmatrix(V, F)).tocsr()
    n = A.shape[0]
    rng = np.random.default_rng(0)
    known = np.sort(rng.choice(n, size=10, replace=False))
    M = massmatrix(V, F)
    B = np.asarray(M @ np.ones(n))
    B[known] = 0.0
    data = min_quad_with_fixed_mg_precompute(A, known, mg, dtype=jnp.float32)
    assert data.A64 is not None  # built automatically for f32 under x64
    z0 = rng.uniform(-1, 1, n)
    # auto-engages: tol 1e-10 << 1e-6 * ||RHS||
    z, r_his, ok = min_quad_with_fixed_mg_solve(
        data, B, known_val=np.zeros(known.size), z0=z0,
        tolerance=1e-10, max_iter=40,
    )
    assert ok, r_his
    assert r_his[-1] < 1e-10
    # plain f32 path at the same tolerance stalls above it
    z2, r2, ok2 = min_quad_with_fixed_mg_solve(
        data, B, known_val=np.zeros(known.size), z0=z0,
        tolerance=1e-10, max_iter=40, refine=False,
    )
    assert not ok2 and r2[-1] > r_his[-1]
    # both agree with the direct solution to f32-class accuracy; IR to f64
    unknown = np.setdiff1d(np.arange(n), known)
    z_ref = sp.linalg.spsolve(
        A[unknown][:, unknown].tocsc(),
        B[unknown] - A[unknown][:, known] @ np.zeros(known.size),
    )
    assert np.abs(z[unknown] - z_ref).max() < 1e-8 * max(
        1.0, np.abs(z_ref).max()
    )
