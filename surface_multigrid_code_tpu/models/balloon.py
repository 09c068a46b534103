"""Balloon inflation simulation (reference example 06).

Nonlinear implicit Euler with multigrid Newton solves
(sim_utils/implicit_euler_mg_balloon.h:18-124):

per Newton iteration (x10):
    K   = stretching Hessian at curPos
    H   = M + dt^2 K
    g   = -(M (qdot - qdot0) + dt G + dt fExt)
    dx  = multigrid solve H dx = g  (block hierarchy reused, Galerkin redone,
          tol 2e-1 — reference main.cpp:42)
    backtracking line search on E(qdot + alpha dx) with c = 1e-8, p = 0.5
    qdot += alpha dx;  curPos = curPos0 + dt * qdot

per outer step (main.cpp:113-122): fExt = -N_v * M_v * 1e6 (inflation
pressure along vertex normals), M = 1000 * 3-expanded lumped mass.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.models.shell import ShellEnergy, lame_parameters
from surface_multigrid_code_tpu.ops.laplacian import massmatrix


def lumped_mass_matrix(V, F) -> sp.csr_matrix:
    """3-expanded lumped (voronoi) mass matrix over interleaved xyz DOFs
    (sim_utils/lumped_mass_matrix.cpp)."""
    Mv = massmatrix(V, F, kind="voronoi")
    d = np.asarray(Mv.diagonal())
    return sp.diags(np.repeat(d, 3)).tocsr()


def vertex_normals(V, F) -> np.ndarray:
    """Area-weighted per-vertex normals (igl::per_vertex_normals default)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    N = np.zeros_like(V)
    for c in range(3):
        np.add.at(N, F[:, c], fn)
    nrm = np.linalg.norm(N, axis=1, keepdims=True)
    nrm[nrm == 0] = 1.0
    return N / nrm


class BalloonNewtonSolver:
    """Per-Newton-iteration Hessian refresh on the fixed block hierarchy.

    The reference re-runs the full multigrid precompute (Eigen SpGEMM chain
    + LDLT) every Newton iteration (implicit_euler_mg_balloon.h:75); here
    the symbolic structure is cached once and each iteration only scatters
    the new per-face 9x9 stiffness blocks into the finest nnz values and
    runs the jitted refresh+solve program (solver/refresh.py).
    """

    def __init__(self, shell: ShellEnergy, M: sp.csr_matrix, mg, cfg=None,
                 dtype=None, build_solver: bool = True,
                 psd_project: bool = True):
        import jax
        import jax.numpy as jnp
        from surface_multigrid_code_tpu.solver.refresh import (
            RefreshableMGSolver,
            csr_slot_map,
        )

        # Per-face PSD projection (models/shell.psd_project_blocks): the
        # raw shell Hessians go indefinite under large deformation (the
        # reference's pressure-1e6 operating point) and an SPD-assuming
        # f32 multigrid then diverges; clamping is a bitwise no-op for
        # already-PSD faces, so moderate-load trajectories are unchanged.
        self.psd_project = bool(psd_project)

        # Chebyshev default: interleaved block patterns need ~21 GS colors
        # (vertex graph x K3), making colored sweeps scatter-heavy; the
        # Chebyshev recurrence is one SpMV + axpys per step
        cfg = cfg or SolveConfig(smoother=SmootherType.CHEBYSHEV)
        n3 = M.shape[0]
        rows, cols = shell._rows, shell._cols
        if shell.bending:
            rows = np.concatenate([rows, shell._rows_b])
            cols = np.concatenate([cols, shell._cols_b])
        K_pat = sp.coo_matrix(
            (np.ones(rows.shape[0]), (rows, cols)), shape=(n3, n3)
        ).tocsr()
        pattern = (K_pat + M).tocsr()
        pattern.sum_duplicates()
        self.pattern = pattern
        self.slots = csr_slot_map(pattern, rows, cols)
        # gather-only assembly: for each pattern nnz, the (padded) list of
        # contributing per-face Hessian entry positions
        from surface_multigrid_code_tpu.solver.galerkin import _ellize_segments

        order = np.argsort(self.slots, kind="stable")
        gi, gw, ti, tw, ts = _ellize_segments(
            self.slots[order], order, np.ones(order.shape[0]),
            order.shape[0], pattern.nnz, W_cap=24,
        )
        self.asm_gather = gi
        self.asm_tail_idx = ti   # rare long segments (bending diagonals)
        self.asm_tail_seg = ts
        self.Mdiag_slots = csr_slot_map(
            pattern, np.arange(n3), np.arange(n3)
        )
        # per-nnz mass gather (diagonal mass folded without a scatter)
        md = np.full(pattern.nnz, n3, dtype=np.int64)
        md[self.Mdiag_slots] = np.arange(n3)
        self.mass_gather = md
        self.Mdiag = np.asarray(M.diagonal())
        if dtype is None:
            # x64-aware default (f64 under jax_enable_x64, else f32)
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        # build_solver=False: assembly machinery only (the sharded balloon
        # path routes solves through parallel/halo.py instead)
        self.solver = (
            RefreshableMGSolver(mg, pattern, cfg=cfg, dtype=dtype)
            if build_solver
            else None
        )
        self.shell = shell

    def hessian_values(self, x_flat, dt):
        """Device A0_vals for H = M + dt^2 K at the current positions.

        The per-face Hessian blocks (stretching 9x9 + optional bending
        18x18) are scattered into the finest nnz slots with one on-device
        segment_sum — no host assembly or matrix round-trip (the values
        feed the jitted refresh+solve program directly)."""
        import jax
        import jax.numpy as jnp
        from surface_multigrid_code_tpu.models.shell import (
            psd_project_blocks,
        )

        shell = self.shell
        proj = psd_project_blocks if self.psd_project else (lambda h: h)
        xv = jnp.asarray(x_flat).reshape(-1, 3)
        x9 = xv[jnp.asarray(shell.F)].reshape(-1, 9)
        entries = [proj(self.shell._face_hess(x9, shell.abars)).reshape(-1)]
        if shell.bending:
            x18 = jnp.concatenate(
                [x9, xv[jnp.asarray(shell.opp)].reshape(-1, 9)], axis=1
            )
            entries.append(
                proj(shell._face_hess_bend(
                    x18, shell.abars, shell.bbars, jnp.asarray(shell.mask)
                )).reshape(-1)
            )
        e = dt * dt * jnp.concatenate(entries)
        epad = jnp.concatenate([e, jnp.zeros(1, dtype=e.dtype)])
        vals = epad[jnp.asarray(self.asm_gather)].sum(axis=1)
        if self.asm_tail_idx.shape[0]:
            vals = vals + jax.ops.segment_sum(
                epad[jnp.asarray(self.asm_tail_idx)],
                jnp.asarray(self.asm_tail_seg),
                num_segments=self.pattern.nnz,
                indices_are_sorted=True,
            )
        mpad = jnp.concatenate(
            [jnp.asarray(self.Mdiag, dtype=vals.dtype),
             jnp.zeros(1, dtype=vals.dtype)]
        )
        return vals + mpad[jnp.asarray(self.mass_gather)]


class DeviceBalloonStepper:
    """Whole implicit-Euler step as ONE jitted device program.

    `implicit_euler_mg_balloon` mirrors the reference's host-orchestrated
    Newton loop (one multigrid solve dispatch + host line search per
    iteration).  This stepper moves the entire step on device:
    lax.fori_loop over Newton iterations, each doing autodiff gradient,
    per-face Hessian assembly (segment_sum into the finest nnz slots),
    cached-symbolic Galerkin refresh + V-cycle solve, and a
    lax.while_loop backtracking line search (c=1e-8, p=0.5, alpha>1e-8,
    unchanged qdot when no step length passes — reference
    implicit_euler_mg_balloon.h:80-114 semantics)."""

    def __init__(self, shell: ShellEnergy, M: sp.csr_matrix, mg, dt: float,
                 mg_tolerance: float = 2e-1, n_newton: int = 10,
                 max_cycles: int = 20, cfg=None, dtype=None,
                 psd_project: bool = True):
        import jax
        import jax.numpy as jnp
        from surface_multigrid_code_tpu.models.shell import (
            psd_project_blocks,
        )
        from surface_multigrid_code_tpu.solver.vcycle import solve_loop

        proj = psd_project_blocks if psd_project else (lambda h: h)
        ns = BalloonNewtonSolver(shell, M, mg, cfg=cfg, dtype=dtype,
                                 psd_project=psd_project)
        self.newton_solver = ns
        solver = ns.solver
        dtype = solver.dtype
        self.dtype = dtype
        cfg = solver.cfg
        dt = float(dt)
        Fj = jnp.asarray(shell.F)
        state = {
            "solver": solver._state,
            "asm_gather": jnp.asarray(ns.asm_gather),
            "asm_tail_idx": jnp.asarray(ns.asm_tail_idx),
            "asm_tail_seg": jnp.asarray(ns.asm_tail_seg),
            "mass_gather": jnp.asarray(ns.mass_gather),
            "Mdiag": jnp.asarray(ns.Mdiag, dtype=dtype),
            "abars": shell.abars.astype(dtype),
            "F": Fj,
        }
        if shell.bending:
            state["opp"] = jnp.asarray(shell.opp)
            state["mask"] = jnp.asarray(shell.mask)
            state["bbars"] = shell.bbars.astype(dtype)

        nnz = ns.pattern.nnz

        def energy(st, x_flat):
            from surface_multigrid_code_tpu.models.shell import _energy_sum

            bend = None
            if shell.bending:
                bend = (st["opp"], st["mask"], st["bbars"])
            return _energy_sum(
                x_flat, st["F"], st["abars"], shell.thickness, shell.alpha,
                shell.beta, shell.material, bend=bend,
            )

        grad_e = jax.grad(energy, argnums=1)
        val_grad_e = jax.value_and_grad(energy, argnums=1)

        def hess_vals(st, x_flat):
            # reuse the shell's vmapped per-face Hessian kernels
            xv = x_flat.reshape(-1, 3)
            x9 = xv[st["F"]].reshape(-1, 9)
            entries = [proj(shell._face_hess(x9, st["abars"])).reshape(-1)]
            if shell.bending:
                x18 = jnp.concatenate(
                    [x9, xv[st["opp"]].reshape(-1, 9)], axis=1
                )
                entries.append(
                    proj(shell._face_hess_bend(
                        x18, st["abars"], st["bbars"], st["mask"]
                    )).reshape(-1)
                )
            e = dt * dt * jnp.concatenate(entries)
            epad = jnp.concatenate([e, jnp.zeros(1, dtype=e.dtype)])
            vals = epad[st["asm_gather"]].sum(axis=1)
            if st["asm_tail_idx"].shape[0]:
                vals = vals + jax.ops.segment_sum(
                    epad[st["asm_tail_idx"]], st["asm_tail_seg"],
                    num_segments=nnz, indices_are_sorted=True,
                )
            mpad = jnp.concatenate(
                [st["Mdiag"], jnp.zeros(1, dtype=st["Mdiag"].dtype)]
            )
            return vals + mpad[st["mass_gather"]]

        def step(st, curPos0, qdot0, fExt):
            curPos0 = curPos0.astype(dtype)
            qdot0 = qdot0.astype(dtype)
            fExt = fExt.astype(dtype)
            Md = st["Mdiag"]

            # No lam hoist anymore: the Chebyshev bound is recomputed
            # inside every refresh (12-iteration power iteration + 1.1x
            # margin, solver/refresh._device_lam_max) so it tracks the
            # drifted in-step spectrum — a stale hoisted estimate can
            # underestimate it, which diverges the window (the
            # pressure-1e6 failure mode).  Power iteration is heuristic;
            # the certified Gershgorin bound (_bsr_gershgorin_lam) is
            # available but costs more V-cycles, and the divergence it
            # would prevent is removed at the source by the per-face PSD
            # projection (models/shell.py).
            lam0 = None

            def total_energy(qdot):
                dq = qdot - qdot0
                Ek = 0.5 * (dq * Md * dq).sum()
                newPos = curPos0.reshape(-1) + dt * qdot
                return Ek + (newPos * fExt).sum() + energy(st, newPos)

            def newton(i, carry):
                qdot, _, nrej = carry
                x = (curPos0.reshape(-1) + dt * qdot)
                # one pass: the elastic energy at x IS total_energy(qdot)'s
                # expensive term (newPos == x), so value_and_grad yields
                # the Newton gradient AND the line-search f0 together
                Ev0, G = val_grad_e(st, x)
                vals = hess_vals(st, x)
                g = -(Md * (qdot - qdot0) + dt * G + dt * fExt)
                hier = solver._refresh_impl(st["solver"], vals, lam_in=lam0)
                dx, _r, _k = solve_loop(
                    hier, g, jnp.zeros_like(g),
                    jnp.asarray(mg_tolerance, dtype=dtype), max_cycles, cfg,
                )
                # backtracking line search
                dq = qdot - qdot0
                f0 = 0.5 * (dq * Md * dq).sum() + (x * fExt).sum() + Ev0
                s = f0 + 1e-8 * (g * dx).sum()

                def ls_cond(c):
                    alpha, found = c
                    return jnp.logical_and(~found, alpha > 1e-8)

                def ls_body(c):
                    alpha, _ = c
                    ok = total_energy(qdot + alpha * dx) <= s
                    return (jnp.where(ok, alpha, alpha * 0.5), ok)

                alpha, found = jax.lax.while_loop(
                    ls_cond, ls_body,
                    (jnp.asarray(1.0, dtype=dtype), jnp.asarray(False)),
                )
                # frozen-state guard: a rejected iteration must leave qdot
                # BITWISE unchanged — `qdot + 0.0 * dx` turns a diverged
                # (inf) dx into NaN and silently corrupts the trajectory
                # (the reference's soft-failure discipline, SURVEY §5.3)
                good = jnp.logical_and(found, jnp.isfinite((dx * dx).sum()))
                qdot = jnp.where(good, qdot + alpha * dx, qdot)
                return (qdot, alpha, nrej + (~good).astype(jnp.int32))

            qdot, _, nrej = jax.lax.fori_loop(
                0, n_newton, newton,
                (qdot0, jnp.asarray(1.0, dtype=dtype), jnp.int32(0)),
            )
            curPos = curPos0 + dt * qdot.reshape(-1, 3)
            return curPos, qdot, nrej

        self._state = state
        self._step = jax.jit(step)

    def step(self, curPos, qdot, fExt):
        """One implicit Euler step; returns (curPos_next, qdot_next).

        Newton iterations whose direction fails the line search (or is
        non-finite) leave the state untouched; their count is reported in
        `self.last_rejected` and warned about — the soft-failure analog of
        the reference returning converged=false."""
        import warnings

        import jax.numpy as jnp

        p, q, nrej = self._step(
            self._state, jnp.asarray(curPos), jnp.asarray(qdot),
            jnp.asarray(fExt),
        )
        self.last_rejected = int(nrej)
        if self.last_rejected:
            warnings.warn(
                f"balloon step: {self.last_rejected} Newton iteration(s)"
                " rejected (line search failed or non-finite direction);"
                " state frozen for those iterations", stacklevel=2,
            )
        return (
            np.asarray(p, dtype=np.float64),
            np.asarray(q, dtype=np.float64),
        )


class BsrBalloonStepper:
    """Implicit-Euler balloon step with the BSR (3x3-block) multigrid.

    Same semantics as DeviceBalloonStepper (reference
    implicit_euler_mg_balloon.h:40-120: 10 Newton iterations of
    H dx = -g with H = M + dt^2 K, backtracking line search), but the
    Hessian lives as 3x3 blocks on the VERTEX graph and the V-cycle runs
    on [nv, 3] states (solver/bsr.py): each SpMV row gathers contiguous
    3-vectors instead of ~36 scattered scalars.

    Takes the SCALAR hierarchy from mg_precompute — the reference's
    3-expanded block prolongation (src/get_prolong.cpp:59-115) is the
    same scalar weight on each DOF of a vertex, i.e. scalar-weighted
    combination of 3-vectors.
    """

    def __init__(self, shell: ShellEnergy, M: sp.csr_matrix, mg, dt: float,
                 mg_tolerance: float = 2e-1, n_newton: int = 10,
                 max_cycles: int = 20, cfg=None, dtype=None,
                 psd_project: bool = True,
                 asm_w_cap: int = 4,
                 coarsest_nv: int = 0):
        import jax
        import jax.numpy as jnp
        from surface_multigrid_code_tpu.models.shell import (
            psd_project_blocks,
        )
        from surface_multigrid_code_tpu.solver.bsr import (
            BsrRefreshableSolver,
            bsr_solve_loop,
        )
        from surface_multigrid_code_tpu.solver.hierarchy import (
            extend_hierarchy,
        )

        # The per-Newton refresh pays a dense Cholesky INVERSE of the
        # coarsest operator; coarsest_nv > 0 extends the given hierarchy
        # below the reference's >500-vertex stopping rule
        # (src/mg_precompute.cpp:94) down to ~coarsest_nv vertices (see
        # solver/hierarchy.extend_hierarchy).  The default 0 keeps the
        # given hierarchy, so the single-device and sharded balloon solve
        # on the same levels.
        if coarsest_nv:
            mg = extend_hierarchy(mg, min_coarsest_nv=coarsest_nv)

        proj = psd_project_blocks if psd_project else (lambda h: h)
        from surface_multigrid_code_tpu.solver.galerkin import _ellize_segments
        from surface_multigrid_code_tpu.solver.refresh import csr_slot_map

        cfg = cfg or SolveConfig(smoother=SmootherType.CHEBYSHEV)
        nv = shell.n
        F = shell.F
        nf = F.shape[0]

        # vertex-pair pattern in the SAME (face, a, b) flatten order as the
        # per-face Hessian blocks below
        rows = [np.repeat(F, 3, axis=1).reshape(-1)]
        cols = [np.tile(F, (1, 3)).reshape(-1)]
        if shell.bending:
            v6 = np.concatenate([F, shell.opp], axis=1)  # [nf, 6]
            rows.append(np.repeat(v6, 6, axis=1).reshape(-1))
            cols.append(np.tile(v6, (1, 6)).reshape(-1))
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        pattern = (
            sp.coo_matrix(
                (np.ones(rows.shape[0]), (rows, cols)), shape=(nv, nv)
            )
            + sp.identity(nv)
        ).tocsr()
        pattern.sum_duplicates()

        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        solver = BsrRefreshableSolver(mg, pattern, cfg=cfg, dtype=dtype)
        self.solver = solver
        self.pattern = solver.pattern_v
        cfg = solver.cfg
        dt = float(dt)
        nnz = pattern.nnz

        opp = None if not shell.bending else shell.opp
        slots = csr_slot_map(solver.pattern_v, rows, cols)
        order = np.argsort(slots, kind="stable")
        # Gather-plan width: off-diagonal vertex pairs receive exactly two
        # face contributions on a closed manifold; a narrow W plus the
        # sorted segment_sum tail for the wide diagonal rows avoids
        # padding every row to the diagonal width.
        gi, gw, ti, tw, ts = _ellize_segments(
            slots[order], order, np.ones(order.shape[0]),
            order.shape[0], nnz, W_cap=asm_w_cap,
        )
        diag_slots = csr_slot_map(
            solver.pattern_v, np.arange(nv), np.arange(nv))
        Mv = np.asarray(M.diagonal())[0::3]
        Mdiag = np.asarray(M.diagonal()).reshape(nv, 3)
        state = {
            "solver": solver._state,
            "asm_gather": jnp.asarray(gi),
            "asm_tail_idx": jnp.asarray(ti),
            "asm_tail_seg": jnp.asarray(ts),
            "diag_slots": jnp.asarray(diag_slots),
            "Mv": jnp.asarray(Mv, dtype=dtype),
            "Mdiag": jnp.asarray(Mdiag.reshape(-1), dtype=dtype),
            "abars": shell.abars.astype(dtype),
            "F": jnp.asarray(F),
        }
        if shell.bending:
            state["opp"] = jnp.asarray(opp)
            state["mask"] = jnp.asarray(shell.mask)
            state["bbars"] = shell.bbars.astype(dtype)

        def energy(st, x_flat):
            from surface_multigrid_code_tpu.models.shell import _energy_sum

            bend = None
            if shell.bending:
                bend = (st["opp"], st["mask"], st["bbars"])
            return _energy_sum(
                x_flat, st["F"], st["abars"], shell.thickness, shell.alpha,
                shell.beta, shell.material, bend=bend,
            )

        grad_e = jax.grad(energy, argnums=1)
        val_grad_e = jax.value_and_grad(energy, argnums=1)

        def face9(st, v_flat):
            """[nv*3] -> [nf, 9] per-face corner states."""
            return v_flat.reshape(-1, 3)[st["F"]].reshape(nf, 9)

        def block_vals(st, x_flat):
            """dt^2 K + M as [nnz_v, 3, 3] blocks (gather-only assembly)."""
            xv = x_flat.reshape(-1, 3)
            x9 = face9(st, x_flat)
            H9 = proj(shell._face_hess(x9, st["abars"]))  # [nf, 9, 9]
            ent = [
                H9.reshape(nf, 3, 3, 3, 3)
                .transpose(0, 1, 3, 2, 4)
                .reshape(nf * 9, 3, 3)
            ]
            if shell.bending:
                x18 = jnp.concatenate(
                    [x9, xv[st["opp"]].reshape(-1, 9)], axis=1
                )
                H18 = proj(shell._face_hess_bend(
                    x18, st["abars"], st["bbars"], st["mask"]
                ))
                ent.append(
                    H18.reshape(nf, 6, 3, 6, 3)
                    .transpose(0, 1, 3, 2, 4)
                    .reshape(nf * 36, 3, 3)
                )
            e = dt * dt * jnp.concatenate(ent)
            epad = jnp.concatenate([e, jnp.zeros((1, 3, 3), dtype=e.dtype)])
            vals = epad[st["asm_gather"]].sum(axis=1)
            if st["asm_tail_idx"].shape[0]:
                vals = vals + jax.ops.segment_sum(
                    epad[st["asm_tail_idx"]], st["asm_tail_seg"],
                    num_segments=nnz, indices_are_sorted=True,
                )
            eye3 = jnp.eye(3, dtype=vals.dtype)
            return vals.at[st["diag_slots"]].add(
                st["Mv"][:, None, None] * eye3
            )

        self._block_vals = block_vals

        # No lam hoist: the Chebyshev bound is recomputed inside each
        # in-loop refresh (power iteration + 1.1x margin) so it tracks the
        # drifted in-step spectrum (a stale hoisted estimate can
        # underestimate it, which diverges the window — the pressure-1e6
        # failure mode).  The certified Gershgorin bound
        # (solver/bsr._bsr_gershgorin_lam) stays available but costs more
        # V-cycles; the divergence it would prevent is removed at the
        # source by the per-face PSD projection (models/shell.py).

        def step(st, curPos0, qdot0, fExt):
            curPos0 = curPos0.astype(dtype)
            qdot0 = qdot0.astype(dtype)
            fExt = fExt.astype(dtype)
            Md = st["Mdiag"]

            lam0 = None

            def newton(i, carry):
                qdot, _, nrej = carry
                x = curPos0.reshape(-1) + dt * qdot
                # one pass: the elastic energy at x IS the line search's
                # f0 (newPos == x), so value_and_grad yields the Newton
                # gradient AND the Armijo reference together
                Ev0, G = val_grad_e(st, x)
                vals = block_vals(st, x)
                g = -(Md * (qdot - qdot0) + dt * G + dt * fExt)
                hier = solver._refresh_impl(st["solver"], vals, lam_in=lam0)
                dx2, _r, _k = bsr_solve_loop(
                    hier, g.reshape(nv, 3), jnp.zeros((nv, 3), dtype=dtype),
                    jnp.asarray(mg_tolerance, dtype=dtype), max_cycles, cfg,
                )
                dx = dx2.reshape(-1)
                dq = qdot - qdot0
                f0 = 0.5 * (dq * Md * dq).sum() + (x * fExt).sum() + Ev0
                s = f0 + 1e-8 * (g * dx).sum()

                # Line-search energies on the 1-D line x + (alpha*dt)*dx:
                # gather the face corner states of x and dx ONCE (the x9
                # gather CSEs with block_vals'), so each backtracking
                # trial is pure per-face flops — no per-trial gather
                # (reference backtracking semantics
                # sim_utils/implicit_euler_mg_balloon.h:80-114 unchanged)
                from surface_multigrid_code_tpu.models.shell import (
                    face_bending_energy,
                    face_energy,
                )

                x9 = face9(st, x)
                d9 = face9(st, dx)
                if shell.bending:
                    xo9 = x.reshape(-1, 3)[st["opp"]].reshape(nf, 9)
                    do9 = dx.reshape(-1, 3)[st["opp"]].reshape(nf, 9)

                def line_energy(alpha):
                    qd = qdot + alpha * dx
                    dqa = qd - qdot0
                    Ek = 0.5 * (dqa * Md * dqa).sum()
                    newPos = curPos0.reshape(-1) + dt * qd
                    ad = alpha * dt
                    e9 = x9 + ad * d9
                    ev = jax.vmap(
                        lambda a, b: face_energy(
                            a, b, shell.thickness, shell.alpha,
                            shell.beta, shell.material,
                        )
                    )(e9, st["abars"]).sum()
                    if shell.bending:
                        e18 = jnp.concatenate([e9, xo9 + ad * do9], axis=1)
                        ev = ev + jax.vmap(
                            lambda a, b, c, m: face_bending_energy(
                                a, b, c, m, shell.thickness, shell.alpha,
                                shell.beta, shell.material,
                            )
                        )(e18, st["abars"], st["bbars"], st["mask"]).sum()
                    return Ek + (newPos * fExt).sum() + ev

                def ls_cond(c):
                    alpha, found = c
                    return jnp.logical_and(~found, alpha > 1e-8)

                def ls_body(c):
                    alpha, _ = c
                    ok = line_energy(alpha) <= s
                    return (jnp.where(ok, alpha, alpha * 0.5), ok)

                alpha, found = jax.lax.while_loop(
                    ls_cond, ls_body,
                    (jnp.asarray(1.0, dtype=dtype), jnp.asarray(False)),
                )
                # frozen-state guard: `qdot + 0.0 * dx` turns a diverged
                # (inf) direction into NaN; a rejected iteration must
                # leave qdot bitwise unchanged (soft failure, SURVEY §5.3)
                good = jnp.logical_and(found, jnp.isfinite((dx * dx).sum()))
                qdot = jnp.where(good, qdot + alpha * dx, qdot)
                return (qdot, alpha, nrej + (~good).astype(jnp.int32))

            carry = (qdot0, jnp.asarray(1.0, dtype=dtype), jnp.int32(0))
            carry = jax.lax.fori_loop(0, n_newton, newton, carry)
            qdot, _, nrej = carry
            curPos = curPos0 + dt * qdot.reshape(-1, 3)
            return curPos, qdot, nrej

        self._state = state
        self._step = jax.jit(step)

    def step(self, curPos, qdot, fExt):
        """One implicit Euler step; returns (curPos_next, qdot_next).

        Newton iterations whose direction fails the line search (or is
        non-finite) leave the state untouched; the count is reported in
        `self.last_rejected` with a warning — the soft-failure analog of
        the reference returning converged=false.
        """
        import warnings

        import jax.numpy as jnp

        p, q, nrej = self._step(
            self._state,
            jnp.asarray(np.asarray(curPos, dtype=np.float64)),
            jnp.asarray(np.asarray(qdot, dtype=np.float64).reshape(-1)),
            jnp.asarray(np.asarray(fExt, dtype=np.float64).reshape(-1)),
        )
        self.last_rejected = int(nrej)
        if self.last_rejected:
            warnings.warn(
                f"balloon step: {self.last_rejected} Newton iteration(s)"
                " rejected (line search failed or non-finite direction);"
                " state frozen for those iterations", stacklevel=2,
            )
        return (
            np.asarray(p, dtype=np.float64),
            np.asarray(q, dtype=np.float64).reshape(-1),
        )


def implicit_euler_balloon_direct(
    shell: ShellEnergy,
    M: sp.csr_matrix,
    curPos: np.ndarray,
    qdot: np.ndarray,
    fExt: np.ndarray,
    dt: float,
    n_newton: int = 10,
    verbose: bool = True,
    psd_project: bool = False,
):
    """Direct-solver implicit Euler (reference implicit_euler_balloon.h —
    the useMG=false toggle of example 06); sparse LU per Newton iteration
    instead of multigrid.  psd_project=True uses the same per-face PSD
    clamping as the multigrid steppers (needed for apples-to-apples
    comparisons at large deformation, where the raw Hessian goes
    indefinite)."""
    from scipy.sparse.linalg import splu

    qdot0 = qdot.copy()
    curPos0 = curPos.copy()
    qdot = qdot.copy()
    curPos = curPos.copy()

    def total_energy(tmp_qdot):
        Ek = 0.5 * (tmp_qdot - qdot0) @ (M @ (tmp_qdot - qdot0))
        newPos = curPos0 + dt * tmp_qdot.reshape(-1, 3)
        return (
            float(newPos.reshape(-1) @ fExt)
            + Ek
            + shell.energy(newPos.reshape(-1))
        )

    for it in range(n_newton):
        G = shell.gradient(curPos.reshape(-1))
        K = shell.hessian(curPos.reshape(-1), psd_project=psd_project)
        H = (M + dt * dt * K).tocsc()
        g = -(M @ (qdot - qdot0) + dt * G + dt * fExt)
        dx = splu(H).solve(g)
        alpha, p, c = 1.0, 0.5, 1e-8
        s = total_energy(qdot) + c * (g @ dx)
        while alpha > 1e-8:
            if total_energy(qdot + alpha * dx) <= s:
                qdot = qdot + alpha * dx
                break
            alpha *= p
        if verbose:
            print(f"  newton {it} (direct): alpha {alpha}")
        curPos = curPos0 + dt * qdot.reshape(-1, 3)
    return curPos, qdot


def implicit_euler_mg_balloon(
    shell: ShellEnergy,
    M: sp.csr_matrix,
    curPos: np.ndarray,
    qdot: np.ndarray,
    fExt: np.ndarray,
    dt: float,
    mg,
    mg_tolerance: float = 2e-1,
    n_newton: int = 10,
    cfg: SolveConfig | None = None,
    newton_solver: "BalloonNewtonSolver | None" = None,
    verbose: bool = True,
):
    """One implicit Euler step; mutates nothing, returns (curPos, qdot,
    newton_solver)."""
    cfg = cfg or SolveConfig(smoother=SmootherType.MULTICOLOR_GS)
    if newton_solver is None:
        newton_solver = BalloonNewtonSolver(shell, M, mg, cfg=cfg)
    qdot0 = qdot.copy()
    curPos0 = curPos.copy()
    qdot = qdot.copy()
    curPos = curPos.copy()

    def total_energy(tmp_qdot):
        Ek = 0.5 * (tmp_qdot - qdot0) @ (M @ (tmp_qdot - qdot0))
        newPos = curPos0 + dt * tmp_qdot.reshape(-1, 3)
        Eext = float(newPos.reshape(-1) @ fExt)
        Ev = shell.energy(newPos.reshape(-1))
        return Eext + Ek + Ev

    for it in range(n_newton):
        G = shell.gradient(curPos.reshape(-1))
        vals = newton_solver.hessian_values(curPos.reshape(-1), dt)
        g = -(M @ (qdot - qdot0) + dt * G + dt * fExt)

        dx, r_his, ok = newton_solver.solver.solve(
            vals, g, tolerance=mg_tolerance, max_iter=20
        )
        if verbose:
            print(f"  newton {it}: g.dx = {g @ dx:.6e}, cycles {len(r_his)}")

        # backtracking line search (reference :80-114)
        alpha, p, c = 1.0, 0.5, 1e-8
        f0 = total_energy(qdot)
        s = f0 + c * (g @ dx)
        while alpha > 1e-8:
            if total_energy(qdot + alpha * dx) <= s:
                qdot = qdot + alpha * dx
                break
            alpha *= p
        if verbose:
            print(f"  alpha: {alpha}")
        curPos = curPos0 + dt * qdot.reshape(-1, 3)
    return curPos, qdot, newton_solver


def run_balloon(
    V,
    F,
    n_steps: int = 1,
    dt: float = 1e-3,
    thickness: float = 1e-1,
    poisson: float = 0.5,
    young: float = 6e6,
    material: str = "neohookean",
    mg_tolerance: float = 2e-1,
    pressure: float = 1e6,
    mg=None,
    solver: str = "bsr",
    n_newton: int = 10,
    verbose: bool = True,
):
    """Reference main.cpp:154-201 driver: multigrid hierarchy on the rest
    mesh, inflation force recomputed per outer step.  Yields curPos per step.

    solver="bsr" (default): fully-on-device `BsrBalloonStepper` — the
    Hessian lives as 3x3 blocks on the VERTEX graph; `mg` must then be a SCALAR hierarchy (`mg_precompute`).  solver="scalar":
    the host-orchestrated `implicit_euler_mg_balloon` on the 3-expanded
    block hierarchy (`mg_precompute_block`), mirroring the reference's data
    layout (sim_utils/implicit_euler_mg_balloon.h:18-124) — kept as the
    cross-check path."""
    from surface_multigrid_code_tpu.solver.hierarchy import (
        mg_precompute,
        mg_precompute_block,
    )

    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    alpha, beta = lame_parameters(young, poisson)
    shell = ShellEnergy(V, F, thickness, alpha, beta, material)
    M = 1000.0 * lumped_mass_matrix(V, F)

    curPos = V.copy()
    qdot = np.zeros(3 * V.shape[0])

    if solver == "bsr":
        if mg is None:
            mg = mg_precompute(V, F, verbose=verbose)
        stepper = BsrBalloonStepper(
            shell, M, mg, dt, mg_tolerance=mg_tolerance, n_newton=n_newton
        )
        for step in range(n_steps):
            N = vertex_normals(curPos, F)
            Mvd = np.asarray(
                massmatrix(curPos, F, kind="voronoi").diagonal()
            )
            fExt = (-(N * Mvd[:, None]) * pressure).reshape(-1)
            curPos, qdot = stepper.step(curPos, qdot, fExt)
            if verbose:
                print(
                    f"step {step}: max |disp| = "
                    f"{np.abs(curPos - V).max():.4f}"
                )
            yield curPos
        return

    if solver != "scalar":
        raise ValueError(f"unknown solver {solver!r} (want 'bsr'|'scalar')")
    if mg is None:
        mg = mg_precompute_block(V, F, verbose=verbose)
    newton_solver = None
    for step in range(n_steps):
        N = vertex_normals(curPos, F)
        Mvd = np.asarray(massmatrix(curPos, F, kind="voronoi").diagonal())
        fExt = (-(N * Mvd[:, None]) * pressure).reshape(-1)
        curPos, qdot, newton_solver = implicit_euler_mg_balloon(
            shell, M, curPos, qdot, fExt, dt, mg,
            mg_tolerance=mg_tolerance, n_newton=n_newton,
            newton_solver=newton_solver, verbose=verbose,
        )
        if verbose:
            print(f"step {step}: max |disp| = {np.abs(curPos - V).max():.4f}")
        yield curPos
