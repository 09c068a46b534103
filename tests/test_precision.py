"""Every matrix product on the solver paths asks for Precision.HIGHEST.

At default precision an f32 dot_general may run in TF32 on a GPU
(~3 decimal digits), which would stall the 5e-7 and 1e-10 stop tests.
These cases walk the jaxprs of the solve programs, sub-jaxprs included,
and fail on any dot_general below HIGHEST."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
from surface_multigrid_code_tpu.utils.synthetic import icosphere

HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    if isinstance(value, jcore.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jcore.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from _dots(sub)


def assert_highest(fn, *args):
    closed = jax.make_jaxpr(fn)(*args)
    dots = list(_dots(closed.jaxpr))
    assert dots, "expected matrix products on this path"
    low = [
        (str(e.params.get("precision")), [str(v.aval) for v in e.invars])
        for e in dots
        if e.params.get("precision") != (HIGHEST, HIGHEST)
    ]
    assert not low, low


@pytest.fixture(scope="module")
def sphere():
    V, F = icosphere(2)
    mg = mg_precompute(V, F, min_coarsest_nv=60, verbose=False)
    A = (massmatrix(V, F) - 0.01 * cotmatrix(V, F)).tocsr()
    A.sum_duplicates()
    return V, F, mg, A


@pytest.mark.parametrize("ncols", [1, 3])
@pytest.mark.parametrize(
    "smoother", [SmootherType.MULTICOLOR_GS, SmootherType.CHEBYSHEV])
def test_solve_loop_products_at_highest(sphere, ncols, smoother):
    from surface_multigrid_code_tpu.solver.mqwf_mg import (
        min_quad_with_fixed_mg_precompute,
    )
    from surface_multigrid_code_tpu.solver.vcycle import solve_loop

    V, F, mg, A = sphere
    cfg = SolveConfig(smoother=smoother)
    data = min_quad_with_fixed_mg_precompute(A, None, mg, cfg=cfg,
                                             dtype=jnp.float32)
    shape = (V.shape[0],) if ncols == 1 else (V.shape[0], ncols)
    b = jnp.ones(shape, jnp.float32)
    assert_highest(
        lambda h, b: solve_loop(h, b, jnp.zeros_like(b),
                                jnp.float32(1e-6), 4, cfg),
        data.hier, b)


@pytest.mark.parametrize("constrained", [False, True])
def test_refresh_solve_products_at_highest(sphere, constrained):
    from surface_multigrid_code_tpu.solver.refresh import RefreshableMGSolver

    V, F, mg, A = sphere
    n = V.shape[0]
    known = np.arange(0, n, 50) if constrained else None
    s = RefreshableMGSolver(mg, A, known=known, dtype=jnp.float32)
    vals = jnp.asarray(A.data, jnp.float32)
    tol = jnp.float32(1e-6)
    if constrained:
        nu = s.unknown.size
        rhs = jnp.ones((nu, 3), jnp.float32)
        kv = jnp.ones((known.size, 3), jnp.float32)
        assert_highest(
            lambda st, v, r, k: s._solve_constrained_impl(
                st, v, r, jnp.zeros_like(r), k, tol, 4),
            s._state, vals, rhs, kv)
    else:
        rhs = jnp.ones((n, 3), jnp.float32)
        assert_highest(
            lambda st, v, r: s._solve_impl(st, v, r, jnp.zeros_like(r),
                                           tol, 4),
            s._state, vals, rhs)


def test_bsr_vcycle_products_at_highest(sphere):
    from surface_multigrid_code_tpu.solver.bsr import (
        BsrRefreshableSolver,
    )

    V, F, mg, A = sphere
    nv = V.shape[0]
    pat = (A + sp.identity(nv)).tocsr()
    pat.sum_duplicates()
    s = BsrRefreshableSolver(mg, pat, dtype=jnp.float32)
    blocks = jnp.asarray(
        np.broadcast_to(np.eye(3), (pat.nnz, 3, 3)), jnp.float32)
    rhs = jnp.ones((nv, 3), jnp.float32)
    assert_highest(
        lambda st, v, r: s._solve_impl(st, v, r, jnp.zeros_like(r),
                                       jnp.float32(1e-6), 4),
        s._state, blocks, rhs)


@pytest.mark.parametrize("refreshed", [False, True])
def test_halo_solve_products_at_highest(sphere, refreshed):
    from surface_multigrid_code_tpu.parallel.halo import HaloHierarchy
    from surface_multigrid_code_tpu.parallel.spmd import make_row_mesh
    from surface_multigrid_code_tpu.solver.galerkin import galerkin_chain

    V, F, mg, A = sphere
    Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
    As = galerkin_chain(A, Ps)
    halo = HaloHierarchy(As, Ps, make_row_mesh(2), dtype=jnp.float32)
    rhs = jnp.ones((halo.levels[0]["R"] * 2, 3), jnp.float32)
    args = (halo._lvl_args(), halo.coarse_inv)
    tol = jnp.float32(1e-6)
    if refreshed:
        halo.enable_refresh()
        fn = halo._get_sm(4, 2, refreshed=True)
        assert_highest(fn, halo._refresh_state,
                       jnp.asarray(A.data, jnp.float32), args, rhs,
                       jnp.zeros_like(rhs), tol)
    else:
        fn = halo._get_sm(4, 2, refreshed=False)
        assert_highest(fn, args, rhs, jnp.zeros_like(rhs), tol)


@pytest.mark.parametrize("bending", [False, True])
def test_balloon_step_products_at_highest(bending):
    """The whole implicit-Euler step: shell energies, Hessian assembly,
    PSD projection and the BSR solve."""
    from surface_multigrid_code_tpu.models.balloon import (
        BsrBalloonStepper,
        lumped_mass_matrix,
    )
    from surface_multigrid_code_tpu.models.shell import (
        ShellEnergy,
        lame_parameters,
    )

    V, F = icosphere(2)
    al, be = lame_parameters(6e4, 0.3)
    shell = ShellEnergy(V, F, 0.1, al, be, "neohookean", bending=bending)
    M = 1000.0 * lumped_mass_matrix(V, F)
    mg = mg_precompute(V, F, min_coarsest_nv=60, verbose=False)
    st = BsrBalloonStepper(shell, M, mg, 1e-3, n_newton=2,
                           dtype=jnp.float32)
    x = jnp.asarray(V, jnp.float32)
    q = jnp.zeros(3 * V.shape[0], jnp.float32)
    assert_highest(st._step, st._state, x, q, q)
