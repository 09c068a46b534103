#!/usr/bin/env python3
"""Smoke run of the library's main paths on NVIDIA GPUs.

One JAX process drives each main path through its public entry points at
the sizes users run, compares the result with an independent reference
(f64 on the host unless stated), and prints one JSON object per phase.
The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and appears only if every phase passed.  Without a GPU, or without the
package beside this file, the script exits non-zero and prints no result.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --cards 4  # the multi-device paths, each against
                                    # the single-device path, nothing else

Every f32 device product runs at Precision.HIGHEST (no TF32), so the
tolerances below are f32 tolerances; each check states its reason.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_names() -> list[str]:
    """`name, power.limit` per card, from nvidia-smi (a child process that
    stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


# ----------------------------------------------------------------------
# measurement helpers


def _now() -> float:
    return time.perf_counter()


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k.replace("_size_in_bytes", ""): int(getattr(ma, k))
            for k in keys if hasattr(ma, k)}


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _steady(fn, args, repeats: int) -> dict:
    """Seconds per call after one warm call, each ending in
    block_until_ready."""
    _block(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = _now()
        _block(fn(*args))
        ts.append(_now() - t0)
    return {"median_s": float(np.median(ts)), "min_s": float(min(ts)),
            "repeats": repeats}


def _host_f64():
    """Context for f64 reference computations on the host CPU."""
    import contextlib

    import jax

    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    return stack


class Phase:
    """One phase's JSON record: set-up times, steady times, memory and
    checks against a reference."""

    def __init__(self, name: str, **info):
        self.rec = {"phase": name, **info, "setup_s": {}, "steady": {},
                    "memory": {}, "checks": []}
        self._t = _now()

    def lap(self, key: str):
        t = _now()
        self.rec["setup_s"][key] = t - self._t
        self._t = t

    def restart(self):
        self._t = _now()

    def compiled(self, key: str, lowered):
        """Compile a lowered program, recording time and memory."""
        t0 = _now()
        c = lowered.compile()
        self.rec["setup_s"][f"compile_{key}"] = _now() - t0
        self.rec["memory"][key] = _memory(c)
        self._t = _now()
        return c

    def check(self, name, value, bar, precision, reason, ok=None):
        value = float(value)
        ok = bool(value <= bar) if ok is None else bool(ok)
        self.rec["checks"].append({
            "name": name, "value": value, "bar": bar, "ok": ok,
            "precision": precision, "reason": reason,
        })

    def done(self) -> dict:
        self.rec["peak_bytes_in_use"] = _peak_bytes()
        self.rec["ok"] = all(c["ok"] for c in self.rec["checks"])
        return self.rec


def load_mesh(spec: str):
    """A shipped mesh by name, or `icosphere:<order>`."""
    from surface_multigrid_code_tpu.utils.obj_io import read_obj
    from surface_multigrid_code_tpu.utils.paths import mesh_path
    from surface_multigrid_code_tpu.utils.synthetic import icosphere

    if spec.startswith("icosphere:"):
        return icosphere(int(spec.split(":")[1]))
    return read_obj(mesh_path(spec))


# ----------------------------------------------------------------------
# phase 1: constrained static solve (ex03 semantics)


def phase_static_constrained(mesh: str = "ogre") -> dict:
    import jax.numpy as jnp
    import scipy.sparse.linalg as spla

    from surface_multigrid_code_tpu import (
        mg_precompute,
        min_quad_with_fixed_mg_precompute,
        min_quad_with_fixed_mg_solve,
    )
    from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_tpu.solver.vcycle import solve_loop
    from surface_multigrid_code_tpu.utils.mesh import (
        boundary_vertices,
        normalize_unit_area,
    )

    ph = Phase("static_constrained", mesh=mesh, dtype="float32")
    V, F = load_mesh(mesh)
    V = normalize_unit_area(V, F)
    mg = mg_precompute(V, F)
    A = (-cotmatrix(V, F)).tocsr()
    known = boundary_vertices(F)
    B = np.asarray(massmatrix(V, F) @ np.ones(V.shape[0]))
    B[known] = 0.0
    kv = np.zeros(known.size)
    ph.rec.update(n=int(V.shape[0]), n_known=int(known.size),
                  levels=[int(lv.V.shape[0]) for lv in mg])
    ph.lap("host_build")
    data = min_quad_with_fixed_mg_precompute(A, known, mg,
                                             dtype=jnp.float32)
    _block(data.hier)
    ph.lap("device_build")

    rhs_u = B[data.unknown] - data.Auk @ kv
    bnorm = float(np.linalg.norm(rhs_u))
    tol = 1e-3 * bnorm
    args = (data.hier, jnp.asarray(rhs_u, jnp.float32),
            jnp.zeros(rhs_u.shape, jnp.float32),
            jnp.asarray(tol, jnp.float32))
    solve = ph.compiled("solve_loop", solve_loop.lower(
        *args, max_iter=20, cfg=data.cfg))
    ph.rec["steady"]["solve"] = _steady(solve, args, 10)

    # ex03 as shipped: default tolerance 1e-3 (absolute), 20 V-cycles
    z, r_his, ok = min_quad_with_fixed_mg_solve(data, B, known_val=kv)
    ph.rec.update(ex03_cycles=len(r_his), ex03_r_his=r_his)
    ph.check("ex03_converged", float(not ok), 0.0, "f32",
             "ex03's default solve must converge within 20 V-cycles")
    host_res = float(np.linalg.norm(rhs_u - data.LHS @ z[data.unknown]))
    ph.check(
        "ex03_host_residual_vs_r_his", abs(host_res - r_his[-1]) / host_res,
        0.02, "f64 host residual vs the f32 residual the device recorded",
        "the device evaluates b - A z in f32, with an error of ~1e-4 of "
        "||b|| on this unscaled Laplacian; ex03 stops near 5e-2 of ||b||",
    )

    # the same system to 1e-3 relative, against a direct solve
    z, r_his, ok = min_quad_with_fixed_mg_solve(
        data, B, known_val=kv, tolerance=tol)
    ph.rec.update(cycles=len(r_his), r_his=r_his)
    z_ref = spla.spsolve(data.LHS.tocsc(), rhs_u)
    z_u = z[data.unknown]
    ph.check("converged", float(not ok), 0.0, "f32",
             "the solve must reach 1e-3 relative within 20 V-cycles, "
             "several times above the f32 residual floor (~1.4e-4 of "
             "||b|| at 20K vertices)")
    ph.check(
        "rel_err_vs_direct",
        np.linalg.norm(z_u - z_ref) / np.linalg.norm(z_ref), 1e-3,
        "f32 solve vs f64 scipy spsolve",
        "the f32 residual floor is evaluation noise, not solution error "
        "(the error at the floor is ~3e-6); a 1e-3 relative residual "
        "leaves an error of that order at most",
    )
    return ph.done()


# ----------------------------------------------------------------------
# phase 2: large static solve + SpMV rate


def _ell_spmv_bytes(E) -> int:
    """Bytes one ell_spmv moves at least once: f32 values + int32 indices
    per slot, the x vector read once, y written once."""
    n, w = E.indices.shape
    return 8 * n * w + 4 * E.n_cols + 4 * n


def phase_static_large(order: int = 8, spmv_order: int = 9) -> dict:
    import jax
    import jax.numpy as jnp

    from surface_multigrid_code_tpu import (
        mg_precompute,
        min_quad_with_fixed_mg_precompute,
        min_quad_with_fixed_mg_solve,
    )
    from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
    from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_tpu.ops.sparse import ell_from_csr, ell_spmv
    from surface_multigrid_code_tpu.solver.vcycle import solve_loop
    from surface_multigrid_code_tpu.utils.synthetic import icosphere

    ph = Phase("static_large", mesh=f"icosphere:{order}", dtype="float32",
               smoother="jacobi")
    V, F = icosphere(order)
    mg = mg_precompute(V, F)
    M = massmatrix(V, F)
    A = (M - 0.01 * cotmatrix(V, F)).tocsr()
    rhs = np.asarray(M @ V[:, 0])
    ph.rec.update(n=int(V.shape[0]),
                  levels=[int(lv.V.shape[0]) for lv in mg])
    ph.lap("host_build")
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    data = min_quad_with_fixed_mg_precompute(A, None, mg, cfg=cfg,
                                             dtype=jnp.float32)
    _block(data.hier)
    ph.lap("device_build")

    K = 20
    b = jnp.asarray(rhs, jnp.float32)
    args = (data.hier, b, jnp.zeros_like(b), jnp.asarray(0.0, jnp.float32))
    cycles = ph.compiled("solve_loop", solve_loop.lower(
        *args, max_iter=K, cfg=cfg))
    st = _steady(cycles, args, 5)
    st["per_vcycle_s"] = st["median_s"] / K
    st["note"] = f"{K} V-cycles, each with its residual check"
    ph.rec["steady"]["vcycles"] = st
    # where K cycles with no stop test level off: the f32 residual floor
    r_k = np.asarray(cycles(*args)[1], dtype=np.float64)
    ph.rec["f32_floor_rel"] = float(r_k.min() / np.linalg.norm(rhs))

    tol = 1e-3 * float(np.linalg.norm(rhs))
    z, r_his, ok = min_quad_with_fixed_mg_solve(
        data, rhs, tolerance=tol, max_iter=30)
    ph.rec.update(cycles=len(r_his), r_his=r_his, converged=ok)
    ph.check("converged", float(not ok), 0.0, "f32",
             "the solve must reach 1e-3 relative within 30 V-cycles")
    host_res = float(np.linalg.norm(rhs - A @ z))
    ph.check(
        "host_residual_over_tol", host_res / tol, 2.0,
        "f64 host residual of the f32 solve",
        "the stop test runs on an f32 residual whose evaluation noise "
        "(the floor the 20-cycle run reports, ~8e-5 of ||b|| at this "
        "size) is an order below the 1e-3 relative tolerance; 2x is "
        "margin for that noise and the last cycle's rounding",
    )
    del data, args, cycles

    # SpMV rate on the finest operator of icosphere(spmv_order), alone,
    # next to an elementwise pass over the same bytes in this process
    ph.restart()
    V9, F9 = icosphere(spmv_order)
    A9 = (massmatrix(V9, F9) - 0.01 * cotmatrix(V9, F9)).tocsr()
    ph.lap("host_build_spmv")
    E = ell_from_csr(A9, dtype=jnp.float32)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        A9.shape[0]).astype(np.float32))
    _block((E, x))
    ph.lap("device_build_spmv")
    spmv = ph.compiled("ell_spmv", jax.jit(ell_spmv).lower(E, x))
    nbytes = _ell_spmv_bytes(E)
    buf = jnp.ones((nbytes // 4,), jnp.float32)
    # K dependent applications per call, so dispatch and synchronisation
    # are a small share of the time; the scale keeps the chain bounded
    K = 50
    inv_norm = 1.0 / float(abs(A9).sum(axis=1).max())

    def spmv_chain(E, x):
        return jax.lax.fori_loop(
            0, K, lambda i, y: ell_spmv(E, y) * inv_norm, x)

    def copy_chain(a):
        return jax.lax.fori_loop(0, K, lambda i, b: b * 0.5 + 1.0, a)

    spmv_k = ph.compiled("ell_spmv_chain",
                         jax.jit(spmv_chain).lower(E, x))
    copy_k = ph.compiled("copy_chain", jax.jit(copy_chain).lower(buf))
    t_spmv = _steady(spmv_k, (E, x), 5)
    t_copy = _steady(copy_k, (buf,), 5)
    for t in (t_spmv, t_copy):
        t["per_application_s"] = t["median_s"] / K
    spmv_rate = nbytes / t_spmv["per_application_s"]
    copy_rate = 2 * nbytes / t_copy["per_application_s"]
    ph.rec["spmv"] = {
        "mesh": f"icosphere:{spmv_order}", "rows": int(A9.shape[0]),
        "width": int(E.width), "bytes": nbytes,
        "bytes_model": "8 B per ELL slot (f32 value + int32 index) + x "
                       "read once + y written once",
        "t_spmv": t_spmv, "t_copy": t_copy, "chain": K,
        "copy_model": "elementwise b * 0.5 + 1 over the same byte count "
                      "(read + write)",
        "copy_bytes": 2 * nbytes,
        "spmv_bytes_per_s": spmv_rate, "copy_bytes_per_s": copy_rate,
        "spmv_over_copy": spmv_rate / copy_rate,
    }
    y = np.asarray(spmv(E, x), dtype=np.float64)
    y_ref = A9 @ np.asarray(x, dtype=np.float64)
    ph.check(
        "spmv_rel_err", np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref),
        1e-5, "f32 device SpMV vs f64 scipy",
        "7 f32 products summed per row: a few ulps of each row's "
        "magnitude",
    )
    return ph.done()


# ----------------------------------------------------------------------
# phase 3: mean-curvature flow


def _host_mcf_step(L, mg, F, U, delta, tol, max_iter):
    """One reference-semantics MCF step in f64 on the host: sequential-GS
    V-cycles on the same hierarchy (solver/host_reference.py)."""
    import scipy.sparse as sp

    from surface_multigrid_code_tpu.parallel.mcf import _barycentric_mass
    from surface_multigrid_code_tpu.solver.host_reference import (
        SequentialGSReference,
    )

    mass = _barycentric_mass(U, F)
    A = (sp.diags(mass) - delta * L).tocsr()
    Ps = [mg[lv].P_full.tocsr() for lv in range(1, len(mg))]
    As = [A]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    As[-1] = (As[-1] + 1e-12 * sp.identity(As[-1].shape[0])).tocsr()
    ref = SequentialGSReference(As, Ps)
    Unew, r_his, ok = ref.solve(mass[:, None] * U, z0=U, tolerance=tol,
                                max_iter=max_iter)
    P0, P1, P2 = Unew[F[:, 0]], Unew[F[:, 1]], Unew[F[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(P1 - P0, P2 - P0), axis=1).sum()
    Unew = Unew / np.sqrt(area)
    c = Unew.mean(axis=0)
    Unew = Unew - np.array([c[0], c[1], Unew[:, 2].min()])
    return Unew, r_his, ok


def phase_mcf(mesh: str = "ogre", steps: int = 3) -> dict:
    import jax.numpy as jnp

    from surface_multigrid_code_tpu import mg_precompute
    from surface_multigrid_code_tpu.models.mcf import MCFStepper
    from surface_multigrid_code_tpu.ops.laplacian import cotmatrix
    from surface_multigrid_code_tpu.utils.mesh import normalize_unit_area

    delta, tol = 0.01, 5e-7
    ph = Phase("mcf", mesh=mesh, dtype="float32", steps=steps, delta=delta,
               tol=tol, smoother="multicolor_gs")
    V, F = load_mesh(mesh)
    V = normalize_unit_area(V, F)
    mg = mg_precompute(V, F)
    ph.rec.update(n=int(V.shape[0]))
    ph.lap("host_build")
    stepper = MCFStepper(V, F, mg, delta=delta, mg_tol=tol,
                         dtype=jnp.float32)
    _block(stepper._mcf_state)
    ph.lap("device_build")
    U0 = jnp.asarray(V, jnp.float32)
    step = ph.compiled("step", stepper._step_fn.lower(stepper._mcf_state,
                                                      U0))
    ph.rec["steady"]["step"] = _steady(step, (stepper._mcf_state, U0), 5)

    L = cotmatrix(V, F).tocsr()
    U, Uh = V.copy(), V.copy()
    dev_cycles, ref_cycles, devs = [], [], []
    for _ in range(steps):
        U, r_dev, ok = stepper.step(U)
        Uh, r_ref, ok_ref = _host_mcf_step(L, mg, np.asarray(F), Uh, delta,
                                           tol, 20)
        dev_cycles.append(len(r_dev))
        ref_cycles.append(len(r_ref))
        devs.append(float(np.abs(U - Uh).max()))
        ph.check("converged", float(not ok), 0.0, "f32",
                 "each step must reach 5e-7 within 20 V-cycles")
    ph.rec.update(cycles=dev_cycles, reference_cycles=ref_cycles,
                  max_vertex_dev_per_step=devs)
    ph.check(
        "cycles_over_reference", max(d - r for d, r in
                                     zip(dev_cycles, ref_cycles)), 1,
        "f32 multicolor GS vs f64 sequential GS",
        "DESIGN.md trajectory-parity adjudication: within +1 V-cycle",
    )
    ph.check(
        "max_vertex_dev", max(devs), 1e-4,
        "f32 device trajectory vs f64 host trajectory (unit-area mesh)",
        "each step stops at an absolute residual of 5e-7 on a system "
        "whose rows scale with the vertex mass (~1/n); the solution error "
        "this leaves is ~1e-5 of the unit-area coordinates per step",
    )
    return ph.done()


# ----------------------------------------------------------------------
# phase 4: balloon


def _balloon_setup(V, F):
    from surface_multigrid_code_tpu.models.balloon import (
        lumped_mass_matrix,
        vertex_normals,
    )
    from surface_multigrid_code_tpu.models.shell import (
        ShellEnergy,
        lame_parameters,
    )
    from surface_multigrid_code_tpu.ops.laplacian import massmatrix

    al, be = lame_parameters(6e6, 0.5 - 1e-3)
    shell = ShellEnergy(V, F, 1e-1, al, be, "neohookean")
    M = 1000.0 * lumped_mass_matrix(V, F)
    N = vertex_normals(V, F)
    Mvd = np.asarray(massmatrix(V, F, kind="voronoi").diagonal())
    fExt = (-(N * Mvd[:, None]) * 1e6).reshape(-1)
    return shell, M, fExt


def _direct_direction(V, F, dt):
    """First Newton direction of implicit_euler_balloon_direct at rest
    (qdot = 0), f64 on the host: H = M + dt^2 K_psd, g = -(dt G + dt f)."""
    import scipy.sparse.linalg as spla

    with _host_f64():
        shell, M, fExt = _balloon_setup(V, F)
        x = np.asarray(V, np.float64).reshape(-1)
        G = shell.gradient(x)
        K = shell.hessian(x, psd_project=True)
    g = -(dt * G + dt * fExt)
    H = (M + dt * dt * K).tocsc()
    return spla.splu(H).solve(g), g


def phase_balloon(mesh: str = "bunny_15K_init") -> dict:
    import jax
    import jax.numpy as jnp

    from surface_multigrid_code_tpu import mg_precompute
    from surface_multigrid_code_tpu.models.balloon import BsrBalloonStepper
    from surface_multigrid_code_tpu.models.shell import psd_project_blocks

    dt = 1e-3
    ph = Phase("balloon", mesh=mesh, dtype="float32", pressure=1e6, dt=dt,
               n_newton=10, mg_tol=2e-1, material="neohookean")
    V, F = load_mesh(mesh)
    shell, M, fExt = _balloon_setup(V, F)
    mg = mg_precompute(V, F)
    ph.rec.update(n=int(V.shape[0]), faces=int(F.shape[0]),
                  levels=[int(lv.V.shape[0]) for lv in mg])
    ph.lap("host_build")
    stepper = BsrBalloonStepper(shell, M, mg, dt, mg_tolerance=2e-1,
                                n_newton=10, dtype=jnp.float32)
    _block(stepper._state)
    ph.lap("device_build")
    x0 = jnp.asarray(V, jnp.float32)
    q0 = jnp.zeros(3 * V.shape[0], jnp.float32)
    f0 = jnp.asarray(fExt, jnp.float32)
    step = ph.compiled("step", stepper._step.lower(stepper._state, x0, q0,
                                                   f0))
    ph.rec["steady"]["step"] = _steady(step, (stepper._state, x0, q0, f0),
                                       3)

    p, q = stepper.step(V, np.zeros(3 * V.shape[0]), fExt)
    ph.rec.update(rejected_newton=int(stepper.last_rejected),
                  max_displacement=float(np.abs(p - V).max()))
    ph.check("positions_finite", float(not np.isfinite(p).all()), 0.0,
             "f32", "one implicit-Euler step must stay finite")

    # the PSD projection alone, at this mesh's stretching blocks
    H9 = jax.jit(shell._face_hess)(
        x0[jnp.asarray(shell.F)].reshape(-1, 9), shell.abars)
    proj = ph.compiled("psd_project", jax.jit(psd_project_blocks).lower(H9))
    ph.rec["steady"]["psd_project"] = _steady(proj, (H9,), 10)
    ph.rec["psd_blocks"] = int(H9.shape[0])

    # first Newton direction vs the f64 direct solve
    dx_ref, g_ref = _direct_direction(V, F, dt)
    vals = jax.jit(stepper._block_vals)(stepper._state, x0.reshape(-1))
    g = np.asarray(-(dt * shell.gradient(x0.reshape(-1)) + dt * fExt))
    gn = float(np.linalg.norm(g))
    dx, r_his, ok = stepper.solver.solve(vals, g, tolerance=1e-4 * gn,
                                         max_iter=300)
    dx_loose, r_loose, _ = stepper.solver.solve(vals, g, tolerance=2e-1,
                                                max_iter=20)
    ref_n = float(np.linalg.norm(dx_ref))
    ph.rec.update(direction_cycles=len(r_his),
                  direction_cycles_at_mg_tol=len(r_loose),
                  direction_rel_err_at_mg_tol=float(
                      np.linalg.norm(dx_loose - dx_ref) / ref_n))
    ph.check("direction_converged", float(not ok), 0.0, "f32",
             "the tight direction solve must reach 1e-4 relative within "
             "300 V-cycles")
    ph.check(
        "direction_rel_err", np.linalg.norm(dx - dx_ref) / ref_n, 1e-3,
        "f32 assembly + PSD projection + BSR multigrid at 1e-4 relative "
        "vs f64 assembly + sparse LU",
        "f32 per-face Hessians carry ~1e-6 relative error and the solve "
        "stops at 1e-4 relative residual on a mass-dominated operator "
        "(dt=1e-3), whose error has run at ~0.1-1x the relative "
        "residual; 1e-3 leaves 10x margin",
    )
    return ph.done()


# ----------------------------------------------------------------------
# phase 5: point queries


def phase_queries(mesh: str = "bunny", target_faces: int = 1000,
                  n_random: int = 100_000) -> dict:
    import jax

    from surface_multigrid_code_tpu.query.device import (
        _query_fwd,
        pad_log,
        query_fine_to_coarse_device,
    )
    from surface_multigrid_code_tpu.query.maps import query_fine_to_coarse
    from surface_multigrid_code_tpu.ssp.decimate import SSP_decimate

    ph = Phase("queries", mesh=mesh, target_faces=target_faces,
               dtype="float32", direction="fine_to_coarse")
    V, F = load_mesh(mesh)
    ok, Vc, Fc, IMF, IM, log = SSP_decimate(V, F, target_faces, 0)
    assert ok
    rng = np.random.default_rng(0)
    # every fine vertex (one-hot at its first incident face) + random
    # surface points
    first = np.full(V.shape[0], F.shape[0])
    np.minimum.at(first, F.ravel(), np.repeat(np.arange(F.shape[0]), 3))
    fids = np.concatenate([first, rng.integers(0, F.shape[0], n_random)])
    BC = rng.dirichlet(np.ones(3), fids.shape[0])
    BC[:V.shape[0]] = F[first] == np.arange(V.shape[0])[:, None]
    BF = F[fids]
    ph.rec.update(n_points=int(fids.shape[0]), coarse_faces=int(Fc.shape[0]))
    ph.lap("host_build")
    dlog = pad_log(log)
    _block(dlog)
    ph.lap("device_build")
    args = (dlog, jax.numpy.asarray(BC, "float32"),
            jax.numpy.asarray(BF, "int32"), jax.numpy.asarray(fids, "int32"))
    walk = ph.compiled("walk", _query_fwd.lower(*args))
    ph.rec["steady"]["walk"] = _steady(walk, args, 5)

    t0 = _now()
    h_bc, h_bf, _ = query_fine_to_coarse(log, BC, BF, fids)
    ph.rec["host_walk_s"] = _now() - t0
    d_bc, d_bf, _ = query_fine_to_coarse_device(dlog, BC, BF, fids)
    pos_h = (h_bc[:, :, None] * Vc[h_bf]).sum(1)
    pos_d = (d_bc[:, :, None] * Vc[d_bf]).sum(1)
    err = np.linalg.norm(pos_h - pos_d, axis=1) / np.ptp(V, axis=0).max()
    ph.rec["median_rel_err"] = float(np.median(err))
    ph.check(
        "median_rel_err", np.median(err), 1e-6, "f32 device walk vs f64 "
        "host walk, relative to the mesh extent",
        "the device carries barycentrics in f32 (~1e-7 relative)",
    )
    ph.check(
        "frac_points_off", float((err > 1e-3).mean()), 0.01,
        "share of points further than 1e-3 of the extent apart",
        "f32 rounding can flip a snap at an exact tie to a neighbouring "
        "face; under 1% of points may land elsewhere",
    )
    return ph.done()


# ----------------------------------------------------------------------
# multi-device phases (--cards N)


def _r_his_rel_dev(r, r_ref, floor: float = 1e-4) -> float:
    """Largest relative deviation of a residual history from a reference
    one over the entries above `floor` of the initial residual; below it
    the f32 evaluation of b - A z is noise at these sizes."""
    r, r_ref = np.asarray(r), np.asarray(r_ref)
    m = min(r.size, r_ref.size)
    keep = r_ref[:m] > floor * r_ref[0]
    return float(np.max(np.abs(r[:m] - r_ref[:m])[keep] / r_ref[:m][keep]))


def _screened_poisson(order: int):
    from surface_multigrid_code_tpu import mg_precompute
    from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_tpu.utils.synthetic import icosphere

    V, F = icosphere(order)
    mg = mg_precompute(V, F)
    M = massmatrix(V, F)
    A = (M - 0.01 * cotmatrix(V, F)).tocsr()
    return mg, A, np.asarray(M @ V[:, 0])


def phase_sharded_static(order: int = 7, ndev: int = 4) -> dict:
    import jax.numpy as jnp

    from surface_multigrid_code_tpu import (
        min_quad_with_fixed_mg_precompute,
        min_quad_with_fixed_mg_solve,
    )
    from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
    from surface_multigrid_code_tpu.parallel.halo import HaloHierarchy
    from surface_multigrid_code_tpu.parallel.spmd import (
        build_sharded_hierarchy,
        make_row_mesh,
        sharded_solve,
    )

    ph = Phase("sharded_static", mesh=f"icosphere:{order}", devices=ndev,
               dtype="float32", smoother="jacobi")
    mg, A, rhs = _screened_poisson(order)
    ph.rec.update(n=int(A.shape[0]))
    ph.lap("host_build")
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    data = min_quad_with_fixed_mg_precompute(A, None, mg, cfg=cfg,
                                             dtype=jnp.float32)
    As = [lv.A for lv in mg]
    Ps = [mg[lv].P for lv in range(1, len(mg))]
    mesh = make_row_mesh(ndev)
    hier, sizes = build_sharded_hierarchy(As, Ps, mesh, dtype=jnp.float32)
    halo = HaloHierarchy(As, Ps, mesh, cfg=cfg, dtype=jnp.float32)
    ph.lap("device_build")
    kw = dict(tolerance=0.0, max_iter=8)
    _, r1, _ = min_quad_with_fixed_mg_solve(data, rhs, refine=False, **kw)
    t0 = _now()
    _, r_spmd, _ = sharded_solve(hier, sizes, mesh, rhs, cfg=cfg,
                                 dtype=jnp.float32, **kw)
    ph.lap("first_call_spmd")
    _, r_halo, _ = halo.solve(rhs, **kw)
    ph.lap("first_call_halo")
    t0 = _now()
    halo.solve(rhs, **kw)
    ph.rec["steady"]["halo_solve_8_cycles_s"] = _now() - t0
    ph.rec.update(r_single=r1, r_spmd=r_spmd, r_halo=r_halo)
    for name, r in (("spmd", r_spmd), ("halo", r_halo)):
        ph.check(
            f"{name}_r_his_rel_dev", _r_his_rel_dev(r, r1), 1e-3,
            "f32 sharded vs f32 single-device residual history, entries "
            "above 1e-4 of the initial residual",
            "the same iteration with sums taken in another order (and "
            "RCM-reordered rows on the halo path): f32 rounding only",
        )
    return ph.done()


def phase_sharded_mcf(mesh: str = "ogre", ndev: int = 4) -> dict:
    import jax.numpy as jnp

    from surface_multigrid_code_tpu import mg_precompute
    from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
    from surface_multigrid_code_tpu.models.mcf import MCFStepper
    from surface_multigrid_code_tpu.parallel.mcf import ShardedMCFStepper
    from surface_multigrid_code_tpu.parallel.spmd import make_row_mesh
    from surface_multigrid_code_tpu.utils.mesh import normalize_unit_area

    ph = Phase("sharded_mcf", mesh=mesh, devices=ndev, dtype="float32",
               smoother="jacobi", tol=5e-7)
    V, F = load_mesh(mesh)
    V = normalize_unit_area(V, F)
    mg = mg_precompute(V, F)
    ph.lap("host_build")
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    single = MCFStepper(V, F, mg, cfg=cfg, dtype=jnp.float32)
    sharded = ShardedMCFStepper(V, F, mg, make_row_mesh(ndev), cfg=cfg,
                                dtype=jnp.float32)
    ph.lap("device_build")
    U1, r1, ok1 = single.step(V.copy())
    U4, r4, ok4 = sharded.step(V.copy())
    ph.lap("first_step")
    ph.rec.update(r_single=r1, r_sharded=r4)
    ph.check("cycle_count_diff", abs(len(r1) - len(r4)), 1,
             "f32 sharded vs single-device",
             "a residual straddling the 5e-7 stop may converge one cycle "
             "apart when partial sums are taken in another order")
    ph.check("r_his_rel_dev", _r_his_rel_dev(r4, r1), 1e-3,
             "f32, entries above 1e-4 of the initial residual",
             "same iteration, f32 rounding only")
    ph.check("max_vertex_dev", np.abs(U4 - U1).max(), 1e-4,
             "f32 (unit-area mesh)",
             "both stop at a 5e-7 residual; see the mcf phase's bar")
    return ph.done()


def phase_sharded_balloon(mesh: str = "bunny_15K_init",
                          ndev: int = 4) -> dict:
    import jax.numpy as jnp

    from surface_multigrid_code_tpu.models.balloon import BalloonNewtonSolver
    from surface_multigrid_code_tpu.parallel.balloon import (
        ShardedBalloonNewton,
    )
    from surface_multigrid_code_tpu.parallel.spmd import make_row_mesh
    from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute_block

    dt = 1e-3
    ph = Phase("sharded_balloon", mesh=mesh, devices=ndev, dtype="float32",
               smoother="chebyshev", hierarchy="mg_precompute_block")
    V, F = load_mesh(mesh)
    shell, M, fExt = _balloon_setup(V, F)
    mg_b = mg_precompute_block(V, F)
    ph.rec.update(dofs=int(3 * V.shape[0]),
                  levels=[int(lv.V.shape[0]) for lv in mg_b])
    ph.lap("host_build")
    single = BalloonNewtonSolver(shell, M, mg_b, dtype=jnp.float32)
    sharded = ShardedBalloonNewton(shell, M, mg_b, make_row_mesh(ndev), dt,
                                   dtype=jnp.float32)
    ph.lap("device_build")
    x = np.asarray(V, np.float64).reshape(-1)
    g = -(dt * shell.gradient(x) + dt * fExt)
    vals = single.hessian_values(x, dt)
    tol = 1e-4 * float(np.linalg.norm(g))
    dx1, r1, ok1 = single.solver.solve(vals, g, tolerance=tol, max_iter=300)
    dx4, r4, ok4 = sharded.solve(vals, g, tolerance=tol, max_iter=300)
    ph.lap("first_solve")
    ph.rec.update(cycles_single=len(r1), cycles_sharded=len(r4))
    ph.check("converged", float(not (ok1 and ok4)), 0.0, "f32",
             "both direction solves must reach 1e-4 relative within 300 "
             "V-cycles")
    ph.check(
        "direction_rel_dev",
        np.linalg.norm(np.asarray(dx4) - dx1) / np.linalg.norm(dx1), 1e-3,
        "f32 sharded vs f32 single-device direction",
        "both stop at a 1e-4 relative residual of the same operator; "
        "their errors are of that order and need not coincide",
    )
    return ph.done()


# ----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="run the multi-device paths on this many cards")
    args = ap.parse_args(argv)

    cards = card_names()  # before JAX touches the card
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    if len(jax.devices()) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees "
              f"{len(jax.devices())} device(s)", file=sys.stderr)
        return 1
    print(json.dumps({"cards": cards, "jax": jax.__version__,
                      "device_kind": dev.device_kind,
                      "device_count": len(jax.devices())}), flush=True)

    sys.path.insert(0, ROOT)
    from surface_multigrid_code_tpu.ssp import _native
    from surface_multigrid_code_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    t0 = _now()
    lib = _native.get_lib()
    print(json.dumps({"native_build_s": _now() - t0,
                      "native_lib": os.path.basename(lib._name),
                      "compile_cache": enable_persistent_cache()}),
          flush=True)

    if args.cards > 1:
        phases = [
            lambda: phase_sharded_static(ndev=args.cards),
            lambda: phase_sharded_mcf(ndev=args.cards),
            lambda: phase_sharded_balloon(ndev=args.cards),
        ]
    else:
        phases = [phase_static_constrained, phase_static_large, phase_mcf,
                  phase_balloon, phase_queries]
    ok = True
    for run in phases:
        t0 = _now()
        rec = run()
        rec["wall_s"] = _now() - t0
        print(json.dumps(rec), flush=True)
        ok = ok and rec["ok"]
    if not ok:
        print("chip_smoke: a phase failed its checks", file=sys.stderr)
        return 1
    for c in card_names():
        print(c)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
