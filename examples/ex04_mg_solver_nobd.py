"""Example 04 — Poisson with point constraints on a closed mesh
(reference 04_mg_solver_nobd/main.cpp).

The reference loads hilbert_cube.obj (NOT shipped in the repo — only the
constraint marker mesh hilbert_cube_known.obj is) and constrains the
vertices nearest to the marker mesh, solving to tol 1e-10 from a random
initial guess.  We substitute the closed bunny.obj and pick the constrained
vertices nearest to the marker-mesh points, keeping everything else
(A = -L, B = M @ 1 with B(b) = 0, random z0, tol 1e-10) identical.
"""

import numpy as np

from common import out_path
from surface_multigrid_code_tpu import (
    mg_precompute,
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.utils.mesh import normalize_unit_area
from surface_multigrid_code_tpu.utils.obj_io import read_obj
from surface_multigrid_code_tpu.utils.paths import mesh_path


def main():
    # Precision policy (DESIGN.md): tol 1e-10 is below the f32 residual
    # floor.  On CPU the hierarchy is plain f64; on an accelerator the
    # V-cycle hierarchy stays f32 and the solve auto-engages f64
    # mixed-precision iterative refinement (solver/vcycle.py:solve_loop_ir).
    # Whether native f64 throughout is the better choice on the GPU is
    # still open (ROADMAP W3).
    import jax

    jax.config.update("jax_enable_x64", True)
    on_accelerator = jax.devices()[0].platform != "cpu"

    V, F = read_obj(mesh_path("bunny"))
    V_known, _ = read_obj(mesh_path("hilbert_cube_known"))
    # nearest-vertex constraints (reference :40-55)
    d2 = ((V[None, :, :] - V_known[:, None, :]) ** 2).sum(-1)
    b = np.unique(d2.argmin(axis=1))
    V = normalize_unit_area(V, F)
    print(f"original mesh: |V| {V.shape[0]}, |F|: {F.shape[0]}; constraints {b.shape[0]}")

    mg = mg_precompute(V, F, ratio=0.25, min_coarsest_nv=500, dec_type=1)

    A = (-cotmatrix(V, F)).tocsr()
    bval = np.zeros(b.shape[0])
    B = np.asarray(massmatrix(V, F, kind="voronoi") @ np.ones(V.shape[0]))
    B[b] = 0.0
    rng = np.random.default_rng(0)
    z0 = rng.uniform(-1, 1, V.shape[0])

    import jax.numpy as jnp

    data = min_quad_with_fixed_mg_precompute(
        A, b, mg, dtype=jnp.float32 if on_accelerator else jnp.float64
    )
    z, r_his, converged = min_quad_with_fixed_mg_solve(
        data, B, known_val=bval, z0=z0, tolerance=1e-10
    )
    print("residual history:", ["%.4e" % r for r in r_his])
    print("converged:", converged)
    np.savez(out_path("ex04_solution.npz"), z=z, r_his=np.asarray(r_his))
    print(f"wrote {out_path('ex04_solution.npz')}")


if __name__ == "__main__":
    main()
