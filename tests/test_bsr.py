"""BSR (3x3-block) multigrid path vs the scalar-expanded solvers."""

import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from surface_multigrid_code_tpu.models.balloon import (
    BalloonNewtonSolver,
    BsrBalloonStepper,
    DeviceBalloonStepper,
    lumped_mass_matrix,
    vertex_normals,
)
from surface_multigrid_code_tpu.models.shell import ShellEnergy, lame_parameters
from surface_multigrid_code_tpu.ops.laplacian import massmatrix
from surface_multigrid_code_tpu.solver.bsr import BSRMatrix, bsr_spmv
from surface_multigrid_code_tpu.solver.hierarchy import (
    mg_precompute,
    mg_precompute_block,
)
from surface_multigrid_code_tpu.utils.synthetic import icosphere


def setup(bending=False, young=6e4):
    V, F = icosphere(2)
    alpha, beta = lame_parameters(young, 0.3)
    shell = ShellEnergy(V, F, 0.1, alpha, beta, "neohookean", bending=bending)
    M = 1000.0 * lumped_mass_matrix(V, F)
    N = vertex_normals(V, F)
    Mvd = np.asarray(massmatrix(V, F, kind="voronoi").diagonal())
    fExt = (-(N * Mvd[:, None]) * 1e3).reshape(-1)
    return V, F, shell, M, fExt


def test_bsr_spmv_matches_scalar():
    rng = np.random.default_rng(0)
    nv, w = 50, 5
    idx = rng.integers(0, nv, size=(nv, w)).astype(np.int32)
    blocks = rng.normal(size=(nv, w, 3, 3))
    x = rng.normal(size=(nv, 3))
    A = BSRMatrix(
        indices=jnp.asarray(idx), blocks=jnp.asarray(blocks), n_cols=nv
    )
    y = np.asarray(bsr_spmv(A, jnp.asarray(x)))
    y_ref = np.zeros((nv, 3))
    for i in range(nv):
        for k in range(w):
            y_ref[i] += blocks[i, k] @ x[idx[i, k]]
    np.testing.assert_allclose(y, y_ref, atol=1e-12)


def test_bsr_block_assembly_matches_scalar_assembly():
    # the BSR stepper's block Hessian must equal the scalar-expanded
    # Hessian of BalloonNewtonSolver at the same positions
    for bending in (False, True):
        V, F, shell, M, fExt = setup(bending=bending)
        mg_b = mg_precompute_block(V, F, min_coarsest_nv=60, verbose=False)
        mg_v = mg_precompute(V, F, min_coarsest_nv=60, verbose=False)
        dt = 1e-3
        scalar = BalloonNewtonSolver(shell, M, mg_b)
        bsr = BsrBalloonStepper(shell, M, mg_v, dt)
        x = V.reshape(-1) * 1.01
        vals_s = np.asarray(scalar.hessian_values(x, dt))
        H_s = sp.csr_matrix(
            (vals_s, scalar.pattern.indices, scalar.pattern.indptr),
            scalar.pattern.shape,
        )
        blocks = np.asarray(
            bsr._block_vals(bsr._state, jnp.asarray(x))
        )
        pat = bsr.pattern
        nv = pat.shape[0]
        rows_v = np.repeat(np.arange(nv), np.diff(pat.indptr))
        cols_v = pat.indices
        rr = (
            3 * np.repeat(rows_v, 9)
            + np.tile(np.repeat(np.arange(3), 3), rows_v.shape[0])
        )
        cc = (
            3 * np.repeat(cols_v, 9)
            + np.tile(np.tile(np.arange(3), 3), cols_v.shape[0])
        )
        H_b = sp.coo_matrix(
            (blocks.reshape(-1), (rr, cc)), shape=(3 * nv, 3 * nv)
        ).tocsr()
        diff = abs(H_b - H_s)
        assert diff.max() < 1e-8 * max(1.0, abs(H_s).max()), (
            bending, diff.max()
        )


def test_bsr_stepper_matches_scalar_stepper():
    V, F, shell, M, fExt = setup()
    mg_b = mg_precompute_block(V, F, min_coarsest_nv=60, verbose=False)
    mg_v = mg_precompute(V, F, min_coarsest_nv=60, verbose=False)
    dt = 1e-3
    qdot0 = np.zeros(3 * V.shape[0])
    s1 = DeviceBalloonStepper(shell, M, mg_b, dt, mg_tolerance=1e-8,
                              n_newton=3)
    s2 = BsrBalloonStepper(shell, M, mg_v, dt, mg_tolerance=1e-8, n_newton=3)
    p1, q1 = s1.step(V.copy(), qdot0, fExt)
    p2, q2 = s2.step(V.copy(), qdot0, fExt)
    scale = max(1.0, np.abs(p1 - V).max())
    assert np.abs(p1 - p2).max() < 1e-6 * scale
    # second step continues
    p2b, q2b = s2.step(p2, q2, fExt)
    assert np.isfinite(p2b).all()


def test_bsr_stepper_stiff_bending():
    V, F, shell, M, fExt = setup(bending=True, young=6e6)
    mg_v = mg_precompute(V, F, min_coarsest_nv=60, verbose=False)
    s = BsrBalloonStepper(shell, M, mg_v, 1e-3, n_newton=2)
    p, q = s.step(V.copy(), np.zeros(3 * V.shape[0]), fExt)
    assert np.isfinite(p).all() and np.isfinite(q).all()
    assert np.abs(p - V).max() > 0
