"""Multi-chip mean-curvature flow: halo-partitioned per-step solves.

Single-device MCF (models/mcf.py) runs the whole step as one jitted
program.  This stepper keeps the
reference semantics (05_example_mean_curvature_flow/main.cpp:53-80 — per
step solve (M - delta*L) U = M U_pre with L fixed, then re-normalize
area) but routes the solve through `HaloHierarchy.solve_values`: the
finest nnz values are re-assembled each step from the current positions
and every Galerkin level is refreshed *inside* the sharded program, so
per-step work on each device is O(rows/D) with one halo all-gather per
SpMV.

Host work per step is O(n) numpy assembly (face areas -> lumped mass ->
diagonal update of the fixed cotan-Laplacian values); the V-cycle
iteration and the level refresh run sharded on the mesh.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix
from surface_multigrid_code_tpu.parallel.halo import HaloHierarchy
from surface_multigrid_code_tpu.solver.galerkin import galerkin_chain
from surface_multigrid_code_tpu.solver.refresh import csr_slot_map


def _barycentric_mass(U: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Lumped barycentric vertex mass (1/3 of incident face areas)."""
    P0, P1, P2 = U[F[:, 0]], U[F[:, 1]], U[F[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(P1 - P0, P2 - P0), axis=1)
    third = np.repeat(areas / 3.0, 3)
    return np.bincount(F.ravel(), weights=third, minlength=U.shape[0])


class ShardedMCFStepper:
    """MCF stepper whose per-step solve is row-partitioned over a device
    mesh (parallel/halo.py) with in-program Galerkin value refresh.

    Parameters mirror models/mcf.py's MCFStepper; `mg` is the SSP
    hierarchy from `mg_precompute` (P_full per level), `mesh` a 1-D
    jax.sharding.Mesh with axis name "rows".
    """

    def __init__(
        self,
        V: np.ndarray,
        F: np.ndarray,
        mg,
        mesh,
        delta: float = 0.01,
        mg_tol: float = 5e-7,
        max_iter: int = 20,
        cfg: SolveConfig | None = None,
        dtype=jnp.float32,
        reorder: bool = True,
    ):
        self.F = np.asarray(F, dtype=np.int64)
        self.delta = float(delta)
        self.mg_tol = float(mg_tol)
        self.max_iter = int(max_iter)
        cfg = cfg or SolveConfig(smoother=SmootherType.JACOBI)

        L = cotmatrix(V, F).tocsr()
        L.sum_duplicates()
        n = V.shape[0]
        self._diag_slots = csr_slot_map(L, np.arange(n), np.arange(n))
        self._L_vals = -self.delta * L.data

        # finest system with step-0 values; the PATTERN (= L's, diagonal
        # included) is what the halo partition and Galerkin plan key on —
        # later steps only swap values through solve_values
        vals0 = self._L_vals.copy()
        vals0[self._diag_slots] += _barycentric_mass(np.asarray(V), self.F)
        A0 = sp.csr_matrix((vals0, L.indices.copy(), L.indptr.copy()), L.shape)
        Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
        # symbolic-pattern chain: SSP prolongations carry exact-zero weights
        # whose products scipy would drop, de-syncing the refresh plan
        As = galerkin_chain(A0, Ps)
        self.halo = HaloHierarchy(
            As, Ps, mesh, cfg=cfg, dtype=dtype, reorder=reorder
        ).enable_refresh()

    def step(self, U: np.ndarray):
        """One flow step; returns (U_next, r_his list, converged)."""
        U = np.asarray(U, dtype=np.float64)
        mass = _barycentric_mass(U, self.F)
        vals = self._L_vals.copy()
        vals[self._diag_slots] += mass
        rhs = mass[:, None] * U
        Unew, r_his, ok = self.halo.solve_values(
            jnp.asarray(vals),
            rhs,
            z0=U,
            tolerance=self.mg_tol,
            max_iter=self.max_iter,
        )
        # re-normalize to unit area, zero-mean x/y, floor z
        # (reference src/normalize_unit_area.cpp:9-23, as models/mcf.py)
        P0, P1, P2 = Unew[self.F[:, 0]], Unew[self.F[:, 1]], Unew[self.F[:, 2]]
        area = 0.5 * np.linalg.norm(np.cross(P1 - P0, P2 - P0), axis=1).sum()
        Unew = Unew / np.sqrt(area)
        center = Unew.mean(axis=0)
        Unew = Unew - np.array([center[0], center[1], Unew[:, 2].min()])
        return Unew, r_his, ok
