"""Benchmark: V-cycle and balloon-step times on one NVIDIA GPU.

Three measurements on the plain XLA path, each timed on device-resident
arrays and ending in `jax.block_until_ready`:

- icosphere-9 (2,621,442 vertices) screened-Poisson Jacobi V-cycle, the
  regime whose operators stream from device memory; headline `value` is
  its nnz/s (nonzeros touched per V-cycle over the time of one cycle);
- icosphere-7 (163,842 vertices) V-cycle, whose hierarchy fits in L2;
- bunny_15K implicit-Euler balloon step at the reference's pressure 1e6
  (06_example_balloon_sim/main.cpp:113-122): 10 Newton iterations, mg tol
  2e-1, neo-Hookean.

Exits non-zero without a GPU.  Prints ONE JSON line on stdout, naming the
device and the card's power limit.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _nnz_per_cycle(As, Ps) -> int:
    """nnz touched per V-cycle: 2+2 smoother sweeps + residual per
    non-coarsest level, restrict + prolong per transfer."""
    L = len(As)
    return sum(5 * int(A.nnz) for A in As[: L - 1]) + sum(
        2 * int(P.nnz) for P in Ps)


def _time(fn, args, repeats):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def vcycle_point(order: int, K: int = 20) -> dict:
    """Per-V-cycle time of the jitted solve loop (K cycles, each with its
    residual check) on icosphere(order)'s screened Poisson system."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from ico_ops_cache import load_ops

    from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
    from surface_multigrid_code_tpu.solver.vcycle import (
        build_device_hierarchy,
        solve_loop,
    )

    t0 = time.perf_counter()
    As, Ps = load_ops(order)
    t_ops = time.perf_counter() - t0
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    t0 = time.perf_counter()
    hier = build_device_hierarchy(As, Ps, cfg=cfg, dtype=jnp.float32)
    jax.block_until_ready(hier)
    t_build = time.perf_counter() - t0
    b = jnp.asarray(np.random.default_rng(0).standard_normal(
        As[0].shape[0]).astype(np.float32))
    args = (hier, b, jnp.zeros_like(b), jnp.asarray(0.0, jnp.float32))
    t0 = time.perf_counter()
    loop = solve_loop.lower(*args, max_iter=K, cfg=cfg).compile()
    t_compile = time.perf_counter() - t0
    t_cycle = _time(loop, args, 5) / K
    _, r_his, _ = loop(*args)
    r_his = np.asarray(r_his, dtype=np.float64)
    nnz = _nnz_per_cycle(As, Ps)
    return {
        "n": int(As[0].shape[0]),
        "levels": [int(A.shape[0]) for A in As],
        "t_vcycle_ms": t_cycle * 1e3,
        "nnz_per_cycle": nnz,
        "nnz_per_s": nnz / t_cycle,
        "residual_reduction_per_cycle": float(
            (r_his[-1] / r_his[0]) ** (1.0 / (K - 1))),
        "t_ops_s": t_ops,
        "t_device_build_s": t_build,
        "t_compile_s": t_compile,
    }


def balloon_point() -> dict:
    import jax
    import jax.numpy as jnp

    from surface_multigrid_code_tpu.models.balloon import (
        BsrBalloonStepper,
        lumped_mass_matrix,
        vertex_normals,
    )
    from surface_multigrid_code_tpu.models.shell import (
        ShellEnergy,
        lame_parameters,
    )
    from surface_multigrid_code_tpu.ops.laplacian import massmatrix
    from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
    from surface_multigrid_code_tpu.utils.obj_io import read_obj
    from surface_multigrid_code_tpu.utils.paths import mesh_path

    V, F = read_obj(mesh_path("bunny_15K_init"))
    al, be = lame_parameters(6e6, 0.5 - 1e-3)
    shell = ShellEnergy(V, F, 1e-1, al, be, "neohookean")
    M = 1000.0 * lumped_mass_matrix(V, F)
    mg = mg_precompute(V, F, verbose=False)
    stepper = BsrBalloonStepper(shell, M, mg, 1e-3, mg_tolerance=2e-1,
                                dtype=jnp.float32)
    N = vertex_normals(V, F)
    Mvd = np.asarray(massmatrix(V, F, kind="voronoi").diagonal())
    fExt = jnp.asarray((-(N * Mvd[:, None]) * 1e6).reshape(-1),
                       jnp.float32)
    args = (stepper._state, jnp.asarray(V, jnp.float32),
            jnp.zeros(3 * V.shape[0], jnp.float32), fExt)
    t0 = time.perf_counter()
    step = stepper._step.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    t_step = _time(step, args, 3)
    p = np.asarray(step(*args)[0])
    if not np.isfinite(p).all():
        raise RuntimeError("balloon step produced non-finite positions")
    return {"t_step_ms": t_step * 1e3, "t_compile_s": t_compile,
            "pressure": 1e6, "n_newton": 10}


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from surface_multigrid_code_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()
    ico9 = vcycle_point(9)
    ico7 = vcycle_point(7)
    balloon = balloon_point()
    print(json.dumps({
        "metric": "vcycle_nnz_throughput_ico9",
        "value": ico9["nnz_per_s"] / 1e9,
        "unit": "Gnnz/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "detail": {"ico9": ico9, "ico7": ico7, "balloon_bunny15k": balloon},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
