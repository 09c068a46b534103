"""Scaling harness: row-partitioned V-cycle across a device mesh.

Reports, for each device count D:
  - per-level halo volume (entries exchanged per SpMV) vs local rows —
    the communication/computation ratio of the domain decomposition;
  - solve wall time and residual trajectory (must be identical across D).

On the CPU, --xla_force_host_platform_device_count fakes a mesh
(collective correctness + comm-volume accounting; not a hardware scaling
measurement).  On a host with several GPUs the same script measures
strong scaling over its cards (ROADMAP S5).

Usage:  python benchmarks/scaling.py [--depth 6] [--devices 1 2 4 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp

    from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
    from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
    from surface_multigrid_code_tpu.parallel.halo import HaloHierarchy
    from surface_multigrid_code_tpu.parallel.spmd import make_row_mesh
    from surface_multigrid_code_tpu.utils.synthetic import subdivision_hierarchy

    meshes, Ps = subdivision_hierarchy(args.depth)
    V, F = meshes[0]
    L = cotmatrix(V, F)
    M = massmatrix(V, F)
    A = (M - 0.01 * L).tocsr()
    As = [A]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    rhs = np.asarray(M @ V[:, 0])

    n_avail = len(jax.devices())
    counts = args.devices or [d for d in (1, 2, 4, 8) if d <= n_avail]
    cfg = SolveConfig(smoother=SmootherType.CHEBYSHEV)
    rows = []
    for D in counts:
        mesh = make_row_mesh(D)
        t0 = time.time()
        hier = HaloHierarchy(As, Ps, mesh, cfg=cfg, dtype=jnp.float32)
        t_plan = time.time() - t0
        # warmup + timed solve
        z, r_his, ok = hier.solve(rhs, tolerance=0.0, max_iter=8)
        t0 = time.time()
        z, r_his, ok = hier.solve(rhs, tolerance=0.0, max_iter=8)
        t_solve = time.time() - t0
        halos = [int(lv["S"]) * D for lv in hier.levels]
        locals_ = [int(lv["R"]) for lv in hier.levels]
        rows.append(
            dict(
                devices=D,
                t_plan_s=round(t_plan, 2),
                t_solve_s=round(t_solve, 3),
                halo_entries_per_level=halos,
                local_rows_per_level=locals_,
                comm_ratio_finest=round(halos[0] / max(locals_[0], 1), 4),
                final_residual=r_his[-1],
            )
        )
        print(json.dumps(rows[-1]))
    # residual trajectories must agree across device counts
    return rows


if __name__ == "__main__":
    main()
