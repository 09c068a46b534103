"""Jitted Galerkin multigrid V-cycle on device.

Mirrors the reference recursion (src/mg_VCycle.cpp:3-59): pre-relax,
residual, restrict (PT @ r), recurse with zero initial guess, prolong and
add (P @ uc), post-relax; coarsest level solves additively with a
prefactorized dense factorization (the reference uses SimplicialLDLT with a
1e-12 diagonal shift, src/min_quad_with_fixed_mg.cpp:31-48 — we use dense
LU since the coarsest level is ~500x500 and LU tolerates the near-singular
unconstrained Laplacian case).

The recursion is unrolled in Python over a static tuple of levels, so XLA
sees one flat graph with static shapes per level — the idiomatic way to
handle per-level shape differences under jit.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.sparse import ELLMatrix, ell_from_csr, ell_spmv
from surface_multigrid_code_tpu.ops.smoothers import (
    greedy_coloring,
    color_groups,
    group_scales,
    multicolor_gs_sweep,
    jacobi_sweep,
    chebyshev_smooth,
)

# f32 products must not run in TF32 on the GPU: the stop tests sit at
# 5e-7 (MCF) and below, which a ~1e-3-accurate coarse solve would stall.
HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceLevel:
    """Per-level device data; P/PT map this level to the next-finer level
    (as in reference mg_data: mg[lv].P is n_{lv-1} x n_lv). None at level 0.
    lam_max estimates the largest eigenvalue of D^-1 A (Chebyshev smoothing).
    """

    A: ELLMatrix
    diag: jnp.ndarray
    P: ELLMatrix | None
    PT: ELLMatrix | None
    groups: tuple[jnp.ndarray, ...]
    group_scale: tuple[jnp.ndarray, ...]
    lam_max: jnp.ndarray | None = None

    def tree_flatten(self):
        children = (
            self.A, self.diag, self.P, self.PT, self.groups, self.group_scale,
            self.lam_max,
        )
        return children, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceHierarchy:
    levels: tuple[DeviceLevel, ...]
    coarse_inv: jnp.ndarray  # dense (pseudo-)inverse of the coarsest A

    def tree_flatten(self):
        return (self.levels, self.coarse_inv), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def build_device_hierarchy(
    As: list[sp.spmatrix],
    Ps: list[sp.spmatrix],
    cfg: SolveConfig = SolveConfig(),
    dtype=None,
    colorings: list[np.ndarray] | None = None,
) -> DeviceHierarchy:
    """Host -> device hierarchy build.  dtype defaults x64-aware (f64
    under jax_enable_x64, else f32 — an explicit f64 request under a
    non-x64 runtime would silently truncate with warning spam).

    As: per-level Galerkin matrices (len L), coarsest already diag-shifted.
    Ps: prolongations, Ps[l] maps level l+1 -> level l (len L-1).
    colorings: optional cached row colorings (sparsity is static across
    value refreshes, e.g. MCF's per-step rebuild).
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    L = len(As)
    levels = []
    for lv in range(L):
        A = As[lv].tocsr()
        diag = jnp.asarray(A.diagonal(), dtype=dtype)
        ell = ell_from_csr(A, dtype=dtype)
        if cfg.smoother == SmootherType.MULTICOLOR_GS and lv < L - 1:
            color = (
                colorings[lv]
                if colorings is not None
                else greedy_coloring(A)
            )
            groups_np = color_groups(color)
            groups = tuple(jnp.asarray(g) for g in groups_np)
            group_scale = tuple(
                jnp.asarray(s, dtype=dtype) for s in group_scales(groups_np)
            )
        else:
            groups = ()
            group_scale = ()
        if lv == 0:
            P = PT = None
        else:
            P = ell_from_csr(Ps[lv - 1], dtype=dtype)
            PT = ell_from_csr(Ps[lv - 1].T.tocsr(), dtype=dtype)
        lam_max = None
        if cfg.smoother == SmootherType.CHEBYSHEV:
            lam_max = jnp.asarray(
                _power_iteration_lam_max(A), dtype=dtype
            )
        levels.append(
            DeviceLevel(
                A=ell, diag=diag, P=P, PT=PT, groups=groups,
                group_scale=group_scale, lam_max=lam_max,
            )
        )
    # Coarse solve: the reference prefactorizes with SimplicialLDLT after a
    # +1e-12 diagonal shift (src/min_quad_with_fixed_mg.cpp:31-48).  We
    # instead build a nullspace-deflated pseudo-inverse on host in f64 and
    # apply it as ONE dense matmul on device: no dependent triangular
    # solves inside the V-cycle, and deflation keeps f32 runs stable when
    # the unconstrained Laplacian is singular (the 1e-12 shift is below
    # f32 epsilon, so an f32 LU would blow up).
    Ac = np.asarray(As[-1].todense(), dtype=np.float64)
    Ac = 0.5 * (Ac + Ac.T)
    w, U = np.linalg.eigh(Ac)
    cutoff = max(1e-10 * float(np.abs(w).max()), 1e-300)
    inv_w = np.where(np.abs(w) > cutoff, 1.0 / np.where(w == 0, 1.0, w), 0.0)
    Cinv = (U * inv_w) @ U.T
    return DeviceHierarchy(
        levels=tuple(levels), coarse_inv=jnp.asarray(Cinv, dtype=dtype)
    )


def _power_iteration_lam_max(A: sp.spmatrix, iters: int = 20) -> float:
    """Largest eigenvalue of D^-1 A via host power iteration (Chebyshev
    smoothing bound); 10% safety margin as is conventional."""
    dinv = 1.0 / A.diagonal()
    rng = np.random.default_rng(0)
    x = rng.normal(size=A.shape[0])
    lam = 1.0
    for _ in range(iters):
        x = dinv * (A @ x)
        lam = np.linalg.norm(x)
        x /= lam
    return 1.1 * float(lam)


def _relax(level: DeviceLevel, b, u, cfg: SolveConfig, n_iter: int):
    """n_iter relaxation steps (the reference's `relax` x N,
    src/mg_VCycle.cpp:36,57,113-178)."""
    if cfg.smoother == SmootherType.CHEBYSHEV and level.lam_max is not None:
        return chebyshev_smooth(
            level.A, level.diag, level.lam_max, b, u, degree=n_iter
        )
    for _ in range(n_iter):
        if cfg.smoother == SmootherType.MULTICOLOR_GS and level.groups:
            u = multicolor_gs_sweep(
                level.A, level.diag, level.groups, level.group_scale, b, u,
            )
        else:
            u = jacobi_sweep(
                level.A, level.diag, b, u, weight=cfg.jacobi_weight
            )
    return u


def vcycle(
    hier: DeviceHierarchy,
    b: jnp.ndarray,
    u: jnp.ndarray,
    cfg: SolveConfig = SolveConfig(),
) -> jnp.ndarray:
    """One V-cycle on the finest level (recursion unrolled; jittable).

    b/u: flat [n] or multi-column [n, C]."""

    def go(lv: int, B, U):
        level = hier.levels[lv]
        if lv == hier.n_levels - 1:
            # additive coarse correction (reference src/mg_VCycle.cpp:181-201)
            return U + jnp.matmul(hier.coarse_inv, B, precision=HIGHEST)
        U = _relax(level, B, U, cfg, cfg.pre_relax_iter)
        r = B - ell_spmv(level.A, U)
        nxt = hier.levels[lv + 1]
        rc = ell_spmv(nxt.PT, r)
        uc = jnp.zeros(
            rc.shape if r.ndim > 1 else (nxt.diag.shape[0],), dtype=r.dtype
        )
        uc = go(lv + 1, rc, uc)
        U = U + ell_spmv(nxt.P, uc)
        U = _relax(level, B, U, cfg, cfg.post_relax_iter)
        return U

    return go(0, b, u)


@functools.partial(jax.jit, static_argnames=("max_iter", "cfg"))
def solve_loop(
    hier: DeviceHierarchy,
    rhs: jnp.ndarray,
    z0: jnp.ndarray,
    tol: jnp.ndarray,
    max_iter: int,
    cfg: SolveConfig,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Reference solve loop (src/min_quad_with_fixed_mg.cpp:330-347):
    each iteration records ||rhs - A z|| (Frobenius norm for multi-RHS),
    stops *before* cycling when below tol. Returns (z, r_his, n_recorded);
    r_his is padded to max_iter with -1.
    """
    A0 = hier.levels[0].A

    def resid(z):
        r = rhs - ell_spmv(A0, z)
        return jnp.sqrt((r * r).sum())

    def cond(state):
        k, _, _, done = state
        return jnp.logical_and(~done, k < max_iter)

    def body(state):
        k, z, r_his, _ = state
        res = resid(z)
        r_his = r_his.at[k].set(res)
        done = res < tol
        z = jax.lax.cond(done, lambda zz: zz, lambda zz: vcycle(hier, rhs, zz, cfg), z)
        return (k + 1, z, r_his, done)

    r_his0 = jnp.full((max_iter,), -1.0, dtype=rhs.dtype)
    k, z, r_his, _ = jax.lax.while_loop(cond, body, (0, z0, r_his0, jnp.asarray(False)))
    return z, r_his, k


@functools.partial(jax.jit, static_argnames=("max_iter", "cfg"))
def solve_loop_ir(
    hier: DeviceHierarchy,
    A64: ELLMatrix,
    rhs: jnp.ndarray,
    z0: jnp.ndarray,
    tol: jnp.ndarray,
    max_iter: int,
    cfg: SolveConfig,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Mixed-precision iterative refinement for tolerances below the f32
    residual floor (DESIGN.md "Precision policy").

    The V-cycle and its whole operator hierarchy stay f32 while the outer
    defect correction runs in f64 (only ONE f64 SpMV + axpy per cycle):

        r_k = b - A z_k          (f64, A64 = finest operator in f64)
        e_k = Vcycle(r_k, 0)     (f32)
        z_{k+1} = z_k + e_k      (f64 accumulate)

    A V-cycle is an affine iteration u + B(b - A u) with linear B, so in
    exact arithmetic these iterates equal solve_loop's — r_his is directly
    comparable with the reference's (residual recorded before each cycle,
    break on tol, src/min_quad_with_fixed_mg.cpp:330-347), but the
    attainable floor is f64's ~1e-15 instead of f32's ~1e-6 relative.
    """
    f32 = hier.levels[0].diag.dtype

    def cond(state):
        k, _, _, done = state
        return jnp.logical_and(~done, k < max_iter)

    def body(state):
        k, z, r_his, _ = state
        r = rhs - ell_spmv(A64, z)
        res = jnp.sqrt((r * r).sum())
        r_his = r_his.at[k].set(res)
        done = res < tol
        e = vcycle(hier, r.astype(f32), jnp.zeros(r.shape, dtype=f32), cfg)
        z = jax.lax.cond(
            done, lambda zz: zz, lambda zz: zz + e.astype(z.dtype), z
        )
        return (k + 1, z, r_his, done)

    z0 = z0.astype(rhs.dtype)
    r_his0 = jnp.full((max_iter,), -1.0, dtype=rhs.dtype)
    k, z, r_his, _ = jax.lax.while_loop(
        cond, body, (0, z0, r_his0, jnp.asarray(False))
    )
    return z, r_his, k
