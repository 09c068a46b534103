"""Smoother-trajectory parity: reference sequential-GS vs device smoothers.

The reference cannot be built here (libigl submodule not checked out, no
Eigen, no network), so `solver/host_reference.py` reproduces its V-cycle
trajectory exactly in f64 on the same hierarchy — sequential forward GS
2+2 (src/mg_VCycle.cpp:146-177), prefactorized coarse solve, residual
recorded before each cycle (src/min_quad_with_fixed_mg.cpp:330-347).
This script runs the ex03 (ogre, tol 1e-3) and ex04-style (bunny closed,
tol 1e-10) problems through that mirror and through the device solver
with multicolor-GS, and prints both r_his so the cycle-count comparison
is a recorded artifact (SURVEY.md §7 hard part 3).

Usage: python benchmarks/smoother_parity.py   (f64 hierarchy under
JAX_ENABLE_X64=1, else f32)
"""

import json

import numpy as np


def run_case(name, mesh, tol, constrained_boundary):
    import jax
    import jax.numpy as jnp

    from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
    from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
    from surface_multigrid_code_tpu.solver.host_reference import (
        SequentialGSReference,
    )
    from surface_multigrid_code_tpu.solver.mqwf_mg import (
        min_quad_with_fixed_mg_precompute,
        min_quad_with_fixed_mg_solve,
    )
    from surface_multigrid_code_tpu.utils.mesh import (
        boundary_vertices,
        normalize_unit_area,
    )
    from surface_multigrid_code_tpu.utils.obj_io import read_obj
    from surface_multigrid_code_tpu.utils.paths import mesh_path

    V, F = read_obj(mesh_path(mesh))
    V = normalize_unit_area(V, F)
    mg = mg_precompute(V, F, verbose=False)
    A = (-cotmatrix(V, F)).tocsr()
    n = A.shape[0]
    if constrained_boundary:
        b = boundary_vertices(F)
    else:
        rng = np.random.default_rng(0)
        b = np.sort(rng.choice(n, size=20, replace=False))
    B = np.asarray(massmatrix(V, F) @ np.ones(n))
    B[b] = 0.0
    rng = np.random.default_rng(0)
    z0 = rng.uniform(-1, 1, n) if not constrained_boundary else np.zeros(n)

    cfg = SolveConfig(smoother=SmootherType.MULTICOLOR_GS)
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    data = min_quad_with_fixed_mg_precompute(A, b, mg, cfg=cfg, dtype=dtype)

    ref = SequentialGSReference(
        [lvl.A for lvl in mg], [mg[lv].P for lv in range(1, len(mg))]
    )
    rhs_u = B[data.unknown]
    _, r_ref, ok_ref = ref.solve(
        rhs_u, z0=z0[data.unknown], tolerance=tol, max_iter=40
    )
    _, r_dev, ok_dev = min_quad_with_fixed_mg_solve(
        data, B, known_val=np.zeros(b.size), z0=z0,
        tolerance=tol, max_iter=40,
    )
    return {
        "case": name,
        "mesh": f"{mesh} |V|={n}",
        "tol": tol,
        "sequential_gs_cycles": len(r_ref),
        "device_multicolor_cycles": len(r_dev),
        "sequential_gs_r_his": [float(f"{r:.4e}") for r in r_ref],
        "device_r_his": [float(f"{r:.4e}") for r in r_dev],
        "both_converged": bool(ok_ref and ok_dev),
    }


def main():
    out = [
        run_case("ex03_poisson_boundary", "ogre", 1e-3, True),
        run_case("ex04_poisson_points", "bunny", 1e-10, False),
    ]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
