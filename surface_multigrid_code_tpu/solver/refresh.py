"""Refreshable multigrid solver: device-side value-only rebuilds.

The applications re-run `min_quad_with_fixed_mg_precompute` with a fresh
matrix on a FIXED hierarchy in their hot loops — MCF once per time step
(reference 05_example_mean_curvature_flow/main.cpp:74) and the balloon sim
once per Newton iteration (implicit_euler_mg_balloon.h:75).  The reference
pays a full Eigen SpGEMM chain + LDLT factorization each time.

Here the symbolic work (sparsity, ELL layouts, colorings, halo plans) is
done once; each refresh is a single jitted device program:
  finest nnz values -> Galerkin chain (gather + segment_sum per level)
  -> ELL data scatters -> dense coarsest assembly + Cholesky inverse.
The subsequent V-cycle solve reuses the standard solve_loop.

Requirement: refreshed systems must be SPD (true for MCF's M - delta*L and
the balloon's M + dt^2 K), since the coarsest level is Cholesky-inverted on
device; the one-shot singular-Poisson path keeps the host eigh pseudo-
inverse in build_device_hierarchy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.smoothers import (
    color_groups,
    greedy_coloring,
    group_scales,
)
from surface_multigrid_code_tpu.ops.sparse import (
    HIGHEST,
    ELLMatrix,
    ell_from_csr,
)
from surface_multigrid_code_tpu.solver.galerkin import (
    GalerkinPlan,
    build_galerkin_plan,
    refresh_values,
)
from surface_multigrid_code_tpu.solver.vcycle import (
    DeviceHierarchy,
    DeviceLevel,
    solve_loop,
)


class RefreshableMGSolver:
    """Fixed hierarchy + fixed finest sparsity; per-solve value refresh.

    mg: MGLevel list from mg_precompute[_block]；
    A0_pattern: finest-level CSR whose sparsity every refreshed matrix
    shares (values are irrelevant here).
    """

    def __init__(
        self,
        mg,
        A0_pattern: sp.spmatrix,
        known: np.ndarray | None = None,
        cfg: SolveConfig | None = None,
        dtype=jnp.float32,
        coarsest_shift: float = 1e-12,
        prune_threshold: float = 1e-15,
    ):
        self.cfg = cfg or SolveConfig(smoother=SmootherType.JACOBI)
        self.dtype = dtype
        A0 = A0_pattern.tocsr().copy()
        A0.sum_duplicates()
        self.A0_full_pattern = A0
        n_full = A0.shape[0]
        Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]

        # Constrained path: the known/unknown split, P row-slice and value-
        # based column pruning (reference src/min_quad_with_fixed_mg.cpp:
        # 137-257) depend only on the STATIC pattern and the STATIC P values
        # — compute them once; every refresh then just gathers A_uu / A_uk
        # values out of the full finest nnz vector.
        self.known = (
            np.zeros(0, dtype=np.int64)
            if known is None or len(known) == 0
            else np.asarray(known, dtype=np.int64).ravel()
        )
        self.unknown = np.setdiff1d(np.arange(n_full), self.known)
        if self.known.size:
            rows_keep = self.unknown
            Ps_sliced = []
            for P in Ps:
                P = P.tocsr()[rows_keep].tocsc()
                keep_cols = np.flatnonzero(
                    np.asarray((P > prune_threshold).sum(axis=0)).ravel() > 0
                )
                Ps_sliced.append(P[:, keep_cols].tocsr())
                rows_keep = keep_cols
            Ps = Ps_sliced
            # index maps: A_uu and A_uk nnz -> full-pattern nnz ids
            Auu = A0[self.unknown][:, self.unknown].tocsr()
            Auu.sum_duplicates()
            Auk = A0[self.unknown][:, self.known].tocsr()
            Auk.sum_duplicates()
            self._uu_map = jnp.asarray(
                _submatrix_nnz_map(A0, self.unknown, self.unknown, Auu)
            )
            self._uk_map = jnp.asarray(
                _submatrix_nnz_map(A0, self.unknown, self.known, Auk)
            )
            # Auk ELL layout (no diagonal requirement)
            counts = np.diff(Auk.indptr)
            width = max(int(counts.max(initial=0)), 1)
            r_uk = np.repeat(np.arange(Auk.shape[0]), counts)
            s_uk = np.arange(Auk.nnz) - np.repeat(Auk.indptr[:-1], counts)
            ind_uk = np.zeros((Auk.shape[0], width), dtype=np.int32)
            ind_uk[r_uk, s_uk] = Auk.indices
            self._uk_rows = jnp.asarray(r_uk)
            self._uk_slots = jnp.asarray(s_uk)
            self._uk_shape = (Auk.shape[0], width)
            self._uk_indices = jnp.asarray(ind_uk)
            A0 = Auu
        self.A0_pattern = A0
        self.plan: GalerkinPlan = build_galerkin_plan(A0, Ps)
        self.P_ell = [ell_from_csr(P, dtype=dtype) for P in Ps]
        self.PT_ell = [ell_from_csr(P.T.tocsr(), dtype=dtype) for P in Ps]
        self.coarsest_shift = float(coarsest_shift)

        # static per-level metadata
        self._plans = [self.plan.lvl0, *self.plan.levels]
        self._groups = []
        self._group_scales = []
        if self.cfg.smoother == SmootherType.MULTICOLOR_GS:
            from surface_multigrid_code_tpu.solver.galerkin import plan_pattern

            for pl_ in self._plans[:-1]:
                # real nnz only — ELL padding would add spurious column-0
                # edges and change the coloring (hence the GS trajectory)
                pat = plan_pattern(pl_)
                color = greedy_coloring(pat)
                gs = color_groups(color)
                self._groups.append(tuple(jnp.asarray(g) for g in gs))
                self._group_scales.append(
                    tuple(jnp.asarray(s, dtype=dtype) for s in group_scales(gs))
                )

        # ALL device arrays travel as jit ARGUMENTS via this pytree —
        # closure-capturing them would embed multi-MB (balloon: multi-100MB)
        # constants into every compiled program.
        self._state = {
            "plan": self.plan,
            "P_ell": tuple(self.P_ell),
            "PT_ell": tuple(self.PT_ell),
            "groups": tuple(self._groups),
            "group_scales": tuple(self._group_scales),
        }
        if self.known.size:
            self._state.update(
                uu_map=self._uu_map,
                uk_map=self._uk_map,
                uk_rows=self._uk_rows,
                uk_slots=self._uk_slots,
                uk_indices=self._uk_indices,
            )

        self._refresh = jax.jit(self._refresh_impl)
        # one fused program: refresh + iterate
        self._solve = jax.jit(
            self._solve_impl, static_argnames=("max_iter",)
        )
        self._solve_k = jax.jit(
            self._solve_constrained_impl, static_argnames=("max_iter",)
        )

    # ------------------------------------------------------------------
    def _refresh_impl(self, state, A0_vals: jnp.ndarray,
                      lam_in=None) -> DeviceHierarchy:
        """lam_in: optional per-level Chebyshev lam_max overrides (tuple,
        finest first, None entries computed on device).  Hot loops whose
        operator drifts slowly (balloon Newton iterations) hoist the power
        iteration out of the per-refresh cost and pass slightly inflated
        values from a prologue refresh instead."""
        plan = state["plan"]
        plans = [plan.lvl0, *plan.levels]
        levels_vals = refresh_values(plan, A0_vals.astype(self.dtype))
        levels = []
        L = len(plans)
        groups = state["groups"]
        group_scales = state["group_scales"]
        for lv, (pl_, (data, diag)) in enumerate(zip(plans, levels_vals)):
            n, w = pl_.ell_shape
            ell = ELLMatrix(indices=pl_.ell_indices, data=data, n_cols=n)
            lam_max = None
            if self.cfg.smoother == SmootherType.CHEBYSHEV and lv < L - 1:
                if lam_in is not None and lam_in[lv] is not None:
                    lam_max = lam_in[lv]
                else:
                    # power iteration + 10% margin; the certified-safe
                    # Gershgorin bound widens the Chebyshev window enough
                    # to cost more V-cycles — the divergence it would
                    # prevent is removed at the source by the per-face
                    # PSD projection (models/shell.py)
                    lam_max = _device_lam_max(ell, diag)
            levels.append(
                DeviceLevel(
                    A=ell,
                    diag=diag,
                    P=None if lv == 0 else state["P_ell"][lv - 1],
                    PT=None if lv == 0 else state["PT_ell"][lv - 1],
                    groups=groups[lv] if groups and lv < L - 1 else (),
                    group_scale=(
                        group_scales[lv]
                        if group_scales and lv < L - 1
                        else ()
                    ),
                    lam_max=lam_max,
                )
            )
        # dense coarsest + Cholesky inverse (device; SPD assumed)
        pl_ = plans[-1]
        n, w = pl_.ell_shape
        data, diag = levels_vals[-1]
        rows = jnp.repeat(jnp.arange(n), w).reshape(n, w)
        dense = jnp.zeros((n, n), dtype=self.dtype)
        dense = dense.at[rows, pl_.ell_indices].add(data)
        dense = dense + self.coarsest_shift * jnp.eye(n, dtype=self.dtype)
        chol = jnp.linalg.cholesky(dense)
        eye = jnp.eye(n, dtype=self.dtype)
        inv = jax.scipy.linalg.cho_solve((chol, True), eye)
        return DeviceHierarchy(levels=tuple(levels), coarse_inv=inv)

    def _solve_impl(self, state, A0_vals, rhs, z0, tol, max_iter: int):
        hier = self._refresh_impl(state, A0_vals)
        return solve_loop(hier, rhs, z0, tol, max_iter, self.cfg)

    def _solve_constrained_impl(self, state, A0_vals_full, rhs_u, z0_u, kv,
                                tol, max_iter: int):
        """Constrained refresh+solve: gather A_uu / A_uk values out of the
        FULL finest nnz vector, fold the constraints into the RHS
        (reference src/min_quad_with_fixed_mg.cpp:310-318), then iterate."""
        vals_uu = A0_vals_full[state["uu_map"]]
        uk_vals = A0_vals_full[state["uk_map"]].astype(self.dtype)
        uk_data = jnp.zeros(self._uk_shape, dtype=self.dtype)
        uk_data = uk_data.at[state["uk_rows"], state["uk_slots"]].set(uk_vals)
        gathered = kv[state["uk_indices"]]
        if kv.ndim == 1:
            fold = (uk_data * gathered).sum(axis=1)
        else:
            fold = jnp.einsum(
                "nw,nwr->nr", uk_data, gathered, precision=HIGHEST
            )
        return solve_loop(
            self._refresh_impl(state, vals_uu), rhs_u - fold, z0_u, tol,
            max_iter, self.cfg,
        )

    # ------------------------------------------------------------------
    def solve(
        self,
        A0_vals: np.ndarray,
        rhs: np.ndarray,
        known_val: np.ndarray | None = None,
        z0: np.ndarray | None = None,
        tolerance: float = 1e-3,
        max_iter: int = 20,
    ):
        """Refresh + V-cycle iterate in one device program.

        A0_vals: nnz values of the FULL finest pattern (CSR order); when
        the solver was built with `known`, the unknown/known slicing, RHS
        constraint folding, and back-scatter happen here.  Returns
        (z, r_his, converged) like min_quad_with_fixed_mg_solve.
        """
        from surface_multigrid_code_tpu.utils.profiler import profile_region

        rhs = np.asarray(rhs, dtype=np.float64)
        constrained = self.known.size > 0
        if constrained:
            assert known_val is not None
            kv = np.asarray(known_val, dtype=np.float64)
            rhs_u = rhs[self.unknown]
            z0_u = (
                np.zeros_like(rhs_u)
                if z0 is None
                else np.asarray(z0, dtype=np.float64)[self.unknown]
            )
            with profile_region("MG: refresh+solve", trace=True):
                z_u, r_his, k = self._solve_k(
                    self._state,
                    jnp.asarray(A0_vals),
                    jnp.asarray(rhs_u, dtype=self.dtype),
                    jnp.asarray(z0_u, dtype=self.dtype),
                    jnp.asarray(kv, dtype=self.dtype),
                    jnp.asarray(float(tolerance), dtype=self.dtype),
                    int(max_iter),
                )
                z_u.block_until_ready()
            z_u = np.asarray(z_u, dtype=np.float64)
            z = np.empty_like(rhs)
            z[self.unknown] = z_u
            z[self.known] = kv
        else:
            rhs_d = jnp.asarray(rhs, dtype=self.dtype)
            z0_d = (
                jnp.zeros_like(rhs_d)
                if z0 is None
                else jnp.asarray(z0, dtype=self.dtype)
            )
            with profile_region("MG: refresh+solve", trace=True):
                z, r_his, k = self._solve(
                    self._state,
                    jnp.asarray(A0_vals),
                    rhs_d,
                    z0_d,
                    jnp.asarray(float(tolerance), dtype=self.dtype),
                    int(max_iter),
                )
                z.block_until_ready()
            z = np.asarray(z, dtype=np.float64)
        k = int(k)
        r_list = [float(r) for r in np.asarray(r_his)[:k]]
        converged = bool(r_list and r_list[-1] <= tolerance)
        return z, r_list, converged


def _submatrix_nnz_map(
    A: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray, Asub: sp.csr_matrix
) -> np.ndarray:
    """For each nnz of Asub = A[rows][:, cols] (canonical CSR order), the
    nnz id within A — so submatrix values can be gathered from the full
    value vector on device."""
    col_of = -np.ones(A.shape[1], dtype=np.int64)
    col_of[cols] = np.arange(cols.shape[0])
    out = np.empty(Asub.nnz, dtype=np.int64)
    for si, gi in enumerate(rows):
        lo, hi = A.indptr[gi], A.indptr[gi + 1]
        sub_cols = col_of[A.indices[lo:hi]]
        keep = sub_cols >= 0
        slo, shi = Asub.indptr[si], Asub.indptr[si + 1]
        # A's kept columns appear in the same relative (sorted) order as
        # Asub's canonical column order
        order = np.argsort(sub_cols[keep], kind="stable")
        out[slo:shi] = (lo + np.flatnonzero(keep))[order]
    return out


def _device_lam_max(A: ELLMatrix, diag, iters: int = 12):
    """Power iteration for the D^-1 A spectral bound, on device."""
    from surface_multigrid_code_tpu.ops.sparse import ell_spmv

    def body(i, xl):
        x, lam = xl
        y = ell_spmv(A, x) / diag
        lam = jnp.linalg.norm(y)
        return (y / lam, lam)

    x0 = jnp.ones((A.n_rows,), dtype=diag.dtype) / jnp.sqrt(
        jnp.asarray(A.n_rows, dtype=diag.dtype)
    )
    _, lam = jax.lax.fori_loop(0, iters, body, (x0, jnp.asarray(1.0, diag.dtype)))
    return 1.1 * lam


def csr_slot_map(
    pattern: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray
) -> np.ndarray:
    """nnz slot of every (row, col) pair in the pattern (fully vectorized).

    Used to scatter application-assembled entries (e.g. per-face stiffness
    blocks) straight into A0_vals without building a scipy matrix.
    Canonical CSR keys (row * ncols + col) are globally sorted, so ONE
    np.searchsorted resolves every query."""
    pattern = pattern.tocsr()
    pattern.sort_indices()  # no-op when already canonical
    ncols = pattern.shape[1]
    prows = np.repeat(
        np.arange(pattern.shape[0], dtype=np.int64), np.diff(pattern.indptr)
    )
    pkeys = prows * ncols + pattern.indices
    qkeys = np.asarray(rows, dtype=np.int64) * ncols + np.asarray(
        cols, dtype=np.int64
    )
    slots = np.searchsorted(pkeys, qkeys)
    if slots.max(initial=-1) >= pkeys.shape[0] or not np.array_equal(
        pkeys[np.minimum(slots, pkeys.shape[0] - 1)], qkeys
    ):
        raise ValueError("entry outside pattern")  # survives python -O
    return slots
