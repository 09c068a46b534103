"""Block-sparse (BSR, 3x3 blocks) multigrid for vertex-vector systems.

The balloon sim solves H dx = -g with H = M + dt^2 K on 3#V DOFs
(reference implicit_euler_mg_balloon.h:67-78).  Expanded to a scalar
3#V-row ELL, every row gathers ~36 scattered scalars.  Stored as BSR —
vertex-graph indices [nv, w<=12] gathering ROWS of x [nv, 3] plus a 3x3
block einsum — the same SpMV reads a third of the indices and gathers
contiguous 3-vectors.

This module provides the BSR analog of solver/vcycle.py + refresh.py:
  - BSRMatrix + bsr_spmv
  - bsr_solve_loop: jitted V-cycle iteration on [nv, 3] states
  - BsrRefreshableSolver: cached-symbolic Galerkin refresh where values
    are 3x3 blocks on the VERTEX pattern and prolongations are the SCALAR
    SSP hierarchy (the reference's 3-expanded block P, src/get_prolong.cpp
    :59-115, is exactly "same scalar weight on each of the 3 DOFs" — in
    block land that is a scalar-weighted combination of 3-vectors).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.sparse import (
    HIGHEST,
    ELLMatrix,
    ell_from_csr,
    ell_spmv,
)
from surface_multigrid_code_tpu.solver.galerkin import (
    GalerkinPlan,
    build_galerkin_plan,
)


@jax.tree_util.register_pytree_node_class
@dataclass
class BSRMatrix:
    """Vertex-graph block matrix: indices [nv, w] int32 (0 = padding,
    weight-zero block), blocks [nv, w, 3, 3]."""

    indices: jnp.ndarray
    blocks: jnp.ndarray
    n_cols: int  # vertex count

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def width(self) -> int:
        return self.indices.shape[1]

    def tree_flatten(self):
        return (self.indices, self.blocks), (self.n_cols,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(indices=children[0], blocks=children[1], n_cols=aux[0])


def bsr_spmv(A: BSRMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x with x [nv, 3]: one row gather + 3x3 block contraction."""
    g = x[A.indices]  # [nv, w, 3]
    return jnp.einsum("nwij,nwj->ni", A.blocks, g, precision=HIGHEST)


@jax.tree_util.register_pytree_node_class
@dataclass
class BsrLevel:
    A: BSRMatrix
    diag: jnp.ndarray        # [nv, 3] scalar diagonal of the 3nv system
    P: ELLMatrix | None      # scalar-weight vertex prolongation (to finer)
    PT: ELLMatrix | None
    lam_max: jnp.ndarray | None = None

    def tree_flatten(self):
        return (self.A, self.diag, self.P, self.PT, self.lam_max), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass
class BsrHierarchy:
    levels: tuple[BsrLevel, ...]
    coarse_inv: jnp.ndarray  # dense inverse of the 3nc x 3nc coarsest

    def tree_flatten(self):
        return (self.levels, self.coarse_inv), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def _dinv(level: BsrLevel, v):
    return v / level.diag


def _bsr_relax(level: BsrLevel, b, u, cfg: SolveConfig, n_iter: int):
    if cfg.smoother == SmootherType.CHEBYSHEV and level.lam_max is not None:
        lam_max = level.lam_max
        lam_min = lam_max / 4.0
        theta = 0.5 * (lam_max + lam_min)
        delta = 0.5 * (lam_max - lam_min)
        r = _dinv(level, b - bsr_spmv(level.A, u))
        d = r / theta
        u = u + d
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(n_iter - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = _dinv(level, b - bsr_spmv(level.A, u))
            d = rho_new * rho * d + (2.0 * rho_new / delta) * r
            u = u + d
            rho = rho_new
        return u
    for _ in range(n_iter):
        u = u + cfg.jacobi_weight * _dinv(level, b - bsr_spmv(level.A, u))
    return u


def bsr_vcycle(hier: BsrHierarchy, b, u, cfg: SolveConfig):
    """One V-cycle on [nv, 3] states (reference schedule, 2+2)."""

    def go(lv, B, U):
        level = hier.levels[lv]
        if lv == hier.n_levels - 1:
            nc = level.A.n_rows
            corr = jnp.matmul(
                hier.coarse_inv, B.reshape(3 * nc), precision=HIGHEST
            ).reshape(nc, 3)
            return U + corr
        U = _bsr_relax(level, B, U, cfg, cfg.pre_relax_iter)
        r = B - bsr_spmv(level.A, U)
        nxt = hier.levels[lv + 1]
        rc = ell_spmv(nxt.PT, r)   # [nvc, 3]: scalar weights on 3-vectors
        uc = jnp.zeros_like(rc)
        uc = go(lv + 1, rc, uc)
        U = U + ell_spmv(nxt.P, uc)
        U = _bsr_relax(level, B, U, cfg, cfg.post_relax_iter)
        return U

    return go(0, b, u)


@functools.partial(jax.jit, static_argnames=("max_iter", "cfg"))
def bsr_solve_loop(hier: BsrHierarchy, rhs, z0, tol, max_iter: int,
                   cfg: SolveConfig):
    """V-cycle iteration with residual history (reference
    src/min_quad_with_fixed_mg.cpp:324-339 semantics: absolute 2-norm over
    all 3nv entries, pre-cycle residual recording)."""
    def resid(z):
        r = rhs - bsr_spmv(hier.levels[0].A, z)
        return jnp.sqrt((r * r).sum())

    def cond(state):
        k, _, _, done = state
        return jnp.logical_and(~done, k < max_iter)

    def body(state):
        k, z, r_his, _ = state
        res = resid(z)
        r_his = r_his.at[k].set(res)
        done = res < tol
        z_new = bsr_vcycle(hier, rhs, z, cfg)
        z = jnp.where(done, z, z_new)
        return (k + 1, z, r_his, done)

    r_his0 = jnp.zeros((max_iter,), dtype=rhs.dtype)
    k, z, r_his, _ = jax.lax.while_loop(
        cond, body, (0, z0, r_his0, jnp.asarray(False))
    )
    return z, r_his, k


def _bsr_gershgorin_lam(A: BSRMatrix, diag):
    """Gershgorin UPPER bound on lam_max(D^-1 A) for the Chebyshev window:
    max_i sum_j |a_ij| / d_i over the 3nv scalar rows.

    Guaranteed-safe (can never underestimate) but LOOSE on shell
    Hessians: on bunny_15K at pressure 1e6 the bound widens the window
    enough that the tol-2e-1 solve needs more cycles than with the
    power-iteration estimate.  With the
    per-face PSD projection (models/shell.psd_project_blocks) removing
    the indefiniteness that actually diverged the smoother, power
    iteration + 10% margin is the default; this bound is kept for
    callers that want the certified-safe window."""
    rowsum = jnp.abs(A.blocks).sum(axis=(1, 3))  # [nv, 3]
    return jnp.max(rowsum / jnp.abs(diag))


def _bsr_device_lam_max(A: BSRMatrix, diag, iters: int = 12):
    """Power iteration for lam_max(D^-1 A) on device ([nv,3] states)."""

    def body(i, xl):
        x, lam = xl
        y = bsr_spmv(A, x) / diag
        lam = jnp.sqrt((y * y).sum())
        return (y / lam, lam)

    x0 = jnp.full((A.n_rows, 3), 1.0, dtype=diag.dtype)
    x0 = x0 / jnp.sqrt(jnp.asarray(3.0 * A.n_rows, dtype=diag.dtype))
    _, lam = jax.lax.fori_loop(
        0, iters, body, (x0, jnp.asarray(1.0, diag.dtype))
    )
    return 1.1 * lam


def refresh_block_values(plan: GalerkinPlan, B0_vals: jnp.ndarray,
                         dtype=None, raw: bool = False):
    """All-level Galerkin refresh where values are [nnz, 3, 3] blocks on
    the VERTEX pattern and P weights are scalars — the block analog of
    galerkin.refresh_values.  vals_out[k] = sum w_a w_c B_in[b]."""
    dtype = dtype or B0_vals.dtype
    vals = B0_vals.astype(dtype)
    out = []

    def to_ell(pl_, v):
        if raw:
            return v
        vpad = jnp.concatenate([v, jnp.zeros((1, 3, 3), dtype=dtype)])
        ell = vpad[pl_.ell_gather]               # [n, w, 3, 3]
        dblk = v[pl_.diag_idx]                   # [n, 3, 3]
        diag3 = jnp.diagonal(dblk, axis1=1, axis2=2)
        return ell, diag3

    out.append(to_ell(plan.lvl0, vals))
    for pl_ in plan.levels:
        vpad = jnp.concatenate([vals, jnp.zeros((1, 3, 3), dtype=dtype)])
        vals = (
            pl_.gat_w.astype(dtype)[..., None, None] * vpad[pl_.gat_idx]
        ).sum(axis=1)
        if pl_.tail_idx.shape[0]:
            vals = vals + jax.ops.segment_sum(
                pl_.tail_w.astype(dtype)[:, None, None] * vpad[pl_.tail_idx],
                pl_.tail_seg,
                num_segments=pl_.nnz_out,
                indices_are_sorted=True,
            )
        out.append(to_ell(pl_, vals))
    return out


class BsrRefreshableSolver:
    """Fixed SCALAR hierarchy + fixed vertex sparsity; per-solve 3x3-block
    value refresh.  mg is from mg_precompute (vertex-level, NOT the
    3-expanded mg_precompute_block); pattern_v the vertex-graph CSR whose
    sparsity every refreshed block matrix shares (diagonal required)."""

    def __init__(self, mg, pattern_v: sp.spmatrix,
                 cfg: SolveConfig | None = None, dtype=jnp.float32,
                 coarsest_shift: float = 1e-12):
        self.cfg = cfg or SolveConfig(smoother=SmootherType.CHEBYSHEV)
        assert self.cfg.smoother in (
            SmootherType.CHEBYSHEV, SmootherType.JACOBI
        ), "BSR path supports pointwise smoothers (Chebyshev/Jacobi)"
        self.dtype = dtype
        Av = pattern_v.tocsr().copy()
        Av.sum_duplicates()
        Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
        self.pattern_v = Av
        self.coarsest_shift = float(coarsest_shift)
        self.plan: GalerkinPlan = build_galerkin_plan(Av, Ps)
        self._state = {
            "plan": self.plan,
            "P_ell": tuple(ell_from_csr(P, dtype=dtype) for P in Ps),
            "PT_ell": tuple(
                ell_from_csr(P.T.tocsr(), dtype=dtype) for P in Ps
            ),
        }
        self._refresh = jax.jit(self._refresh_impl)
        self._solve = jax.jit(self._solve_impl, static_argnames=("max_iter",))

    # ------------------------------------------------------------------
    def _lam(self, A, diag3, lv, n_levels, lam_in):
        if self.cfg.smoother != SmootherType.CHEBYSHEV or lv >= n_levels - 1:
            return None
        if lam_in is not None and lam_in[lv] is not None:
            return lam_in[lv]
        return _bsr_device_lam_max(A, diag3,
                                   iters=self.cfg.lam_power_iters)

    def _coarse_inverse(self, nc, w, ell_indices, blocks):
        r3 = (
            3 * jnp.arange(nc)[:, None, None, None]
            + jnp.arange(3)[None, None, :, None]
        )  # [nc, 1, 3, 1]
        c3 = (
            3 * ell_indices[:, :, None, None]
            + jnp.arange(3)[None, None, None, :]
        )  # [nc, w, 1, 3]
        r3b = jnp.broadcast_to(r3, (nc, w, 3, 3))
        c3b = jnp.broadcast_to(c3, (nc, w, 3, 3))
        dense = jnp.zeros((3 * nc, 3 * nc), dtype=self.dtype)
        dense = dense.at[r3b, c3b].add(blocks)
        dense = dense + self.coarsest_shift * jnp.eye(
            3 * nc, dtype=self.dtype
        )
        chol = jnp.linalg.cholesky(dense)
        return jax.scipy.linalg.cho_solve(
            (chol, True), jnp.eye(3 * nc, dtype=self.dtype)
        )

    def _refresh_impl(self, state, B0_vals: jnp.ndarray,
                      lam_in=None) -> BsrHierarchy:
        plan = state["plan"]
        plans = [plan.lvl0, *plan.levels]
        levels_vals = refresh_block_values(plan, B0_vals.astype(self.dtype))
        levels = []
        L = len(plans)
        for lv, (pl_, (blocks, diag3)) in enumerate(zip(plans, levels_vals)):
            n, w = pl_.ell_shape
            A = BSRMatrix(indices=pl_.ell_indices, blocks=blocks, n_cols=n)
            lam_max = self._lam(A, diag3, lv, L, lam_in)
            levels.append(
                BsrLevel(
                    A=A, diag=diag3,
                    P=None if lv == 0 else state["P_ell"][lv - 1],
                    PT=None if lv == 0 else state["PT_ell"][lv - 1],
                    lam_max=lam_max,
                )
            )
        # dense coarsest (3nc x 3nc) + Cholesky inverse (SPD refreshes)
        pl_ = plans[-1]
        nc, w = pl_.ell_shape
        blocks, _ = levels_vals[-1]
        inv = self._coarse_inverse(nc, w, pl_.ell_indices, blocks)
        return BsrHierarchy(levels=tuple(levels), coarse_inv=inv)

    def _solve_impl(self, state, B0_vals, rhs, z0, tol, max_iter: int):
        hier = self._refresh_impl(state, B0_vals)
        return bsr_solve_loop(hier, rhs, z0, tol, max_iter, self.cfg)

    # ------------------------------------------------------------------
    def solve(self, B0_vals, rhs, z0=None, tolerance: float = 1e-3,
              max_iter: int = 20):
        """Refresh + iterate.  B0_vals [nnz_v, 3, 3]; rhs flat [3nv] or
        [nv, 3].  Returns (z flat [3nv] f64, r_his list, converged)."""
        nv = self.pattern_v.shape[0]
        rhs2 = np.asarray(rhs, dtype=np.float64).reshape(nv, 3)
        z02 = (
            np.zeros_like(rhs2)
            if z0 is None
            else np.asarray(z0, dtype=np.float64).reshape(nv, 3)
        )
        z, r_his, k = self._solve(
            self._state, jnp.asarray(B0_vals),
            jnp.asarray(rhs2, dtype=self.dtype),
            jnp.asarray(z02, dtype=self.dtype),
            jnp.asarray(float(tolerance), dtype=self.dtype), max_iter,
        )
        k = int(k)
        r_list = [float(r) for r in np.asarray(r_his)[:k]]
        z = np.asarray(z, dtype=np.float64)
        return (
            z.reshape(3 * nv),
            r_list,
            bool(r_list and r_list[-1] <= tolerance),
        )
