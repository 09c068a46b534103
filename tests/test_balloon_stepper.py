"""DeviceBalloonStepper (fully jitted Newton loop) vs the host-orchestrated
implicit_euler_mg_balloon."""

import numpy as np

from surface_multigrid_code_tpu.models.balloon import (
    DeviceBalloonStepper,
    implicit_euler_mg_balloon,
    lumped_mass_matrix,
    vertex_normals,
)
from surface_multigrid_code_tpu.models.shell import ShellEnergy, lame_parameters
from surface_multigrid_code_tpu.ops.laplacian import massmatrix
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute_block
from surface_multigrid_code_tpu.utils.synthetic import icosphere


def setup(bending=False):
    V, F = icosphere(2)
    alpha, beta = lame_parameters(6e4, 0.3)
    shell = ShellEnergy(V, F, 0.1, alpha, beta, "neohookean", bending=bending)
    M = 1000.0 * lumped_mass_matrix(V, F)
    mg = mg_precompute_block(V, F, min_coarsest_nv=60, verbose=False)
    N = vertex_normals(V, F)
    Mvd = np.asarray(massmatrix(V, F, kind="voronoi").diagonal())
    fExt = (-(N * Mvd[:, None]) * 1e3).reshape(-1)
    return V, F, shell, M, mg, fExt


def test_device_stepper_matches_host():
    V, F, shell, M, mg, fExt = setup()
    dt = 1e-3
    stepper = DeviceBalloonStepper(
        shell, M, mg, dt, mg_tolerance=1e-8, n_newton=3
    )
    qdot0 = np.zeros(3 * V.shape[0])
    p1, q1 = stepper.step(V.copy(), qdot0, fExt)
    p2, q2, _ = implicit_euler_mg_balloon(
        shell, M, V.copy(), qdot0, fExt, dt, mg, n_newton=3,
        mg_tolerance=1e-8, newton_solver=stepper.newton_solver, verbose=False,
    )
    scale = max(1.0, np.abs(p2 - V).max())
    assert np.abs(p1 - p2).max() < 1e-6 * scale
    # second step continues from the first
    p1b, q1b = stepper.step(p1, q1, fExt)
    assert np.isfinite(p1b).all()
    assert np.abs(p1b - V).max() > np.abs(p1 - V).max() * 0.5


def test_device_stepper_bending_runs():
    V, F, shell, M, mg, fExt = setup(bending=True)
    stepper = DeviceBalloonStepper(shell, M, mg, 1e-3, n_newton=2)
    p, q = stepper.step(V.copy(), np.zeros(3 * V.shape[0]), fExt)
    assert np.isfinite(p).all() and np.isfinite(q).all()


def test_psd_project_blocks():
    """Per-face PSD projection: clamps indefinite blocks, leaves PSD
    blocks bitwise untouched (so moderate-load trajectories are
    unchanged)."""
    import numpy as np
    import jax.numpy as jnp
    from surface_multigrid_code_tpu.models.shell import psd_project_blocks

    rng = np.random.default_rng(3)
    B = rng.standard_normal((8, 9, 9))
    H = 0.5 * (B + B.transpose(0, 2, 1))  # indefinite symmetric
    Hpsd = np.einsum("fij,fkj->fik", B, B)  # PSD by construction
    out = np.asarray(psd_project_blocks(jnp.asarray(H)))
    w = np.linalg.eigvalsh(out)
    assert w.min() >= -1e-10 * np.abs(w).max()
    out_psd = np.asarray(psd_project_blocks(jnp.asarray(Hpsd)))
    assert np.array_equal(out_psd, Hpsd), "PSD blocks must pass bitwise"
    # clamped blocks keep their positive part: x^T Hp x >= x^T H x
    x = rng.standard_normal(9)
    assert (x @ out[0] @ x) >= (x @ H[0] @ x) - 1e-8


def test_bsr_stepper_extreme_pressure_finite():
    """Reference operating point robustness (ex06 fExt = -N*M*1e6,
    06_example_balloon_sim/main.cpp:113-122): in f32, the raw Hessian
    goes indefinite under large deformation and the V-cycle used to
    diverge to inf, then `0 * inf` NaN-poisoned the frozen state.  With
    per-face PSD projection + the frozen-state guard the trajectory must
    stay finite and rejected iterations must be counted, not silently
    corrupted."""
    import numpy as np
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
    from surface_multigrid_code_tpu.utils.synthetic import icosphere

    V, F = icosphere(2)
    al, be = lame_parameters(6e6, 0.5 - 1e-3)
    shell = ShellEnergy(V, F, 1e-1, al, be, "neohookean")
    M = 1000.0 * lumped_mass_matrix(V, F)
    mg = mg_precompute(V, F, min_coarsest_nv=40, verbose=False)
    stepper = BsrBalloonStepper(
        shell, M, mg, 1e-3, mg_tolerance=2e-1, dtype=jnp.float32
    )
    curPos = V.copy()
    qdot = np.zeros(3 * V.shape[0])
    for _ in range(3):
        N = vertex_normals(curPos, F)
        Mvd = np.asarray(massmatrix(curPos, F, kind="voronoi").diagonal())
        fExt = (-(N * Mvd[:, None]) * 1e6).reshape(-1)
        curPos, qdot = stepper.step(curPos, qdot, fExt)
        assert np.isfinite(curPos).all() and np.isfinite(qdot).all()
        assert isinstance(stepper.last_rejected, int)

import pytest


@pytest.mark.slow
def test_bsr_stepper_long_horizon_finite():
    """Long-horizon stability at the reference operating point (VERDICT
    r4 item 3; 06_example_balloon_sim/main.cpp:69-140 runs the demo
    indefinitely): 25 implicit-Euler steps at ex06-scaled pressure must
    stay finite with a physical (inflating, then settling) displacement
    profile and no silent state corruption.  This is the CPU-scale guard
    of the invariants the bunny_15K run keeps on the accelerator."""
    import numpy as np
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
    from surface_multigrid_code_tpu.utils.synthetic import icosphere

    V, F = icosphere(2)
    al, be = lame_parameters(6e6, 0.5 - 1e-3)
    shell = ShellEnergy(V, F, 1e-1, al, be, "neohookean")
    M = 1000.0 * lumped_mass_matrix(V, F)
    mg = mg_precompute(V, F, min_coarsest_nv=40, verbose=False)
    stepper = BsrBalloonStepper(
        shell, M, mg, 1e-3, mg_tolerance=2e-1, dtype=jnp.float32
    )
    N = vertex_normals(V, F)
    Mvd = np.asarray(massmatrix(V, F, kind="voronoi").diagonal())
    fExt = (-(N * Mvd[:, None]) * 1e6).reshape(-1)
    curPos = V.copy()
    qdot = np.zeros(3 * V.shape[0])
    disps, rejects = [], 0
    for _ in range(25):
        curPos, qdot = stepper.step(curPos, qdot, fExt)
        assert np.isfinite(curPos).all() and np.isfinite(qdot).all()
        rejects += stepper.last_rejected
        disps.append(float(np.abs(curPos - V).max()))
    # inflates: displacement grows across the trajectory
    assert disps[-1] > disps[0]
    assert max(disps) > 5 * disps[0]
    # no more than a couple of rejected Newton iterations over 250
    assert rejects <= 5


def test_extend_hierarchy_deepens_and_matches():
    """extend_hierarchy continues the reference level rule below the
    given coarsest (the stepper's coarsest_nv knob routes through it) without perturbing the original
    levels, and the deepened stepper reproduces the default-depth
    trajectory to solver tolerance."""
    import numpy as np
    from surface_multigrid_code_tpu.models.balloon import BsrBalloonStepper
    from surface_multigrid_code_tpu.solver.hierarchy import extend_hierarchy

    V, F, shell, M, mg, fExt = setup()
    mg2 = extend_hierarchy(mg, min_coarsest_nv=20)
    assert len(mg2) > len(mg)
    assert mg2[len(mg) - 1] is mg[-1]  # shared records, not copies
    assert mg2[-1].V.shape[0] < mg[-1].V.shape[0]
    # prolongation rows stay convex barycentric
    P = mg2[-1].P_full
    assert P.shape[0] == mg2[-2].V.shape[0]
    rs = np.asarray(P.sum(axis=1)).ravel()
    assert np.allclose(rs, 1.0, atol=1e-12)
    assert P.data.min() >= -1e-12

    qdot0 = np.zeros(3 * V.shape[0])
    s_ref = BsrBalloonStepper(shell, M, mg, 1e-3, mg_tolerance=1e-8,
                              n_newton=3, coarsest_nv=0)
    s_deep = BsrBalloonStepper(shell, M, mg, 1e-3, mg_tolerance=1e-8,
                               n_newton=3, coarsest_nv=20)
    p1, _ = s_ref.step(V.copy(), qdot0, fExt)
    p2, _ = s_deep.step(V.copy(), qdot0, fExt)
    scale = max(1.0, np.abs(p1 - V).max())
    assert np.abs(p1 - p2).max() < 1e-6 * scale


def test_extend_hierarchy_inherits_strategy():
    """extend_hierarchy continues with the strategy the hierarchy was
    built with (MGLevel.dec_type/ratio metadata, round-5 review fix) —
    a qslim stack must not silently grow midpoint levels."""
    import numpy as np
    from surface_multigrid_code_tpu.config import DecimationType
    from surface_multigrid_code_tpu.solver.hierarchy import (
        extend_hierarchy,
        load_hierarchy,
        mg_precompute,
        save_hierarchy,
    )
    from surface_multigrid_code_tpu.utils.synthetic import icosphere

    V, F = icosphere(3)
    mg = mg_precompute(V, F, min_coarsest_nv=150,
                       dec_type=DecimationType.QSLIM, verbose=False)
    assert mg[-1].dec_type == DecimationType.QSLIM
    mg2 = extend_hierarchy(mg, min_coarsest_nv=20)
    assert len(mg2) > len(mg)
    assert all(l.dec_type == DecimationType.QSLIM for l in mg2[1:])
    # metadata survives serialization
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "h.npz")
        save_hierarchy(p, mg2)
        mg3 = load_hierarchy(p)
    assert mg3[-1].dec_type == DecimationType.QSLIM
    assert mg3[-1].ratio == 0.25
    np.testing.assert_array_equal(mg3[-1].F, mg2[-1].F)
