"""Mean-curvature flow with a fully device-resident step.

Reference driver (05_example_mean_curvature_flow/main.cpp:53-80): per step
solve (M - delta * L) U = M U_pre with L fixed (cotan Laplacian of the
ORIGINAL mesh), M the barycentric mass of the CURRENT mesh, mg tol 5e-7,
then re-normalize surface area — re-running the full multigrid precompute
each step.

The whole step is ONE jitted program:
  U -> barycentric mass diag (device assembly)
    -> finest nnz values (-delta * L_vals, diag += mass)
    -> cached-symbolic Galerkin refresh of all levels (solver/galerkin.py)
    -> V-cycle iterate to tolerance (3-column RHS)
    -> area renormalization (reference src/normalize_unit_area.cpp:9-23)
No host work besides the single dispatch.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.laplacian import (
    cotmatrix,
    massmatrix_barycentric_diag_jax,
)
from surface_multigrid_code_tpu.solver.refresh import (
    RefreshableMGSolver,
    csr_slot_map,
)
from surface_multigrid_code_tpu.solver.vcycle import solve_loop


class MCFStepper:
    """Device-resident MCF (Kazhdan et al. 2012 flow)."""

    def __init__(
        self,
        V: np.ndarray,
        F: np.ndarray,
        mg,
        delta: float = 0.01,
        mg_tol: float = 5e-7,
        max_iter: int = 20,
        cfg: SolveConfig | None = None,
        dtype=jnp.float32,
    ):
        self.F = np.asarray(F, dtype=np.int64)
        self.delta = float(delta)
        self.mg_tol = float(mg_tol)
        self.max_iter = int(max_iter)
        cfg = cfg or SolveConfig(smoother=SmootherType.MULTICOLOR_GS)
        L = cotmatrix(V, F).tocsr()
        L.sum_duplicates()
        self.solver = RefreshableMGSolver(mg, L, cfg=cfg, dtype=dtype)
        n = V.shape[0]
        diag_slots = csr_slot_map(L, np.arange(n), np.arange(n))
        # device buffers travel as jit arguments (see solver/galerkin.py on
        # why closure-captured arrays must be avoided)
        self._mcf_state = {
            "solver": self.solver._state,
            "L_vals": jnp.asarray(-self.delta * L.data, dtype=dtype),
            "F": jnp.asarray(self.F),
            "diag_slots": jnp.asarray(diag_slots),
        }

        def step(state, U):
            U = U.astype(dtype)
            Fj = state["F"]
            mass = massmatrix_barycentric_diag_jax(U, Fj)
            vals = state["L_vals"].at[state["diag_slots"]].add(mass)
            rhs = mass[:, None] * U
            hier = self.solver._refresh_impl(state["solver"], vals)
            Unew, r_his, k = solve_loop(
                hier,
                rhs,
                U,
                jnp.asarray(self.mg_tol, dtype=dtype),
                self.max_iter,
                cfg,
            )
            # re-normalize to unit area, zero-mean x/y, floor z
            # (reference src/normalize_unit_area.cpp:9-23)
            P0, P1, P2 = Unew[Fj[:, 0]], Unew[Fj[:, 1]], Unew[Fj[:, 2]]
            area = 0.5 * jnp.linalg.norm(
                jnp.cross(P1 - P0, P2 - P0), axis=1
            ).sum()
            Unew = Unew / jnp.sqrt(area)
            center = Unew.mean(axis=0)
            Unew = Unew - jnp.array(
                [center[0], center[1], Unew[:, 2].min()]
            )
            return Unew, r_his, k

        self._step_fn = jax.jit(step)
        self._step = lambda U: self._step_fn(self._mcf_state, U)

    def step(self, U: np.ndarray):
        """One flow step; returns (U_next, r_his list, converged)."""
        Unew, r_his, k = self._step(jnp.asarray(U))
        k = int(k)
        r_list = [float(r) for r in np.asarray(r_his)[:k]]
        return (
            np.asarray(Unew, dtype=np.float64),
            r_list,
            bool(r_list and r_list[-1] <= self.mg_tol),
        )
