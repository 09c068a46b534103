"""Sharded MCF on a boundary-bearing SSP hierarchy (VERDICT r4 item 4).

All previous multi-device coverage used closed icospheres or synthetic
subdivision prolongations; this runs the real SSP pipeline on ogre_sim
(2,612 V / 5,072 F, 150 boundary vertices — the decimated companion of
the reference's own constrained-solve mesh, 03_mg_solver/main.cpp:29)
through ShardedMCFStepper on the faked 8-device mesh and asserts the
residual histories match the single-device stepper digit-for-digit.
"""

import numpy as np

import jax.numpy as jnp
import pytest

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.models.mcf import MCFStepper
from surface_multigrid_code_tpu.parallel.mcf import ShardedMCFStepper
from surface_multigrid_code_tpu.parallel.spmd import make_row_mesh
from surface_multigrid_code_tpu.solver.hierarchy import mg_precompute
from surface_multigrid_code_tpu.utils.mesh import (
    boundary_vertices,
    normalize_unit_area,
)
from surface_multigrid_code_tpu.utils.obj_io import read_obj
from surface_multigrid_code_tpu.utils.paths import mesh_path


@pytest.fixture(scope="module")
def ogre_sim_setup():
    V, F = read_obj(mesh_path("ogre_sim"))
    assert boundary_vertices(F).size > 0, "mesh must carry a boundary"
    V = normalize_unit_area(V, F)
    mg = mg_precompute(V, F, verbose=False)
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    single = MCFStepper(V, F, mg, cfg=cfg, dtype=jnp.float64)
    U, r_his, ok = single.step(V.copy())
    assert ok, r_his
    return V, F, mg, cfg, U, r_his


def test_sharded_boundary_mcf_matches_single_device(ogre_sim_setup):
    V, F, mg, cfg, U1, r1 = ogre_sim_setup
    sharded = ShardedMCFStepper(
        V, F, mg, make_row_mesh(4), cfg=cfg, dtype=jnp.float64,
    )
    U4, r4, ok4 = sharded.step(V.copy())
    assert ok4, r4
    assert len(r4) == len(r1)
    np.testing.assert_allclose(r4, r1, rtol=1e-10)
    np.testing.assert_allclose(U4, U1, atol=1e-12)
