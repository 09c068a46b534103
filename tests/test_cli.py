"""CLI smoke tests (subprocess; CPU platform)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from surface_multigrid_code_tpu.utils.obj_io import read_obj, write_obj
from surface_multigrid_code_tpu.utils.synthetic import icosphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "surface_multigrid_code_tpu", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )


@pytest.fixture()
def sphere_obj(tmp_path):
    V, F = icosphere(2)
    p = tmp_path / "sphere.obj"
    write_obj(p, V, F)
    return p


def test_cli_decimate_and_log(tmp_path, sphere_obj):
    r = run_cli(
        ["decimate", str(sphere_obj), "-t", "80", "-o", "out.obj",
         "--log", "log.npz"],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr
    V, F = read_obj(tmp_path / "out.obj")
    assert F.shape[0] <= 80
    assert (tmp_path / "log.npz").exists()


def test_cli_remesh(tmp_path, sphere_obj):
    r = run_cli(
        ["remesh", str(sphere_obj), "-t", "40", "-n", "1", "-o", "rm"],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr
    V0, F0 = read_obj(tmp_path / "rm_s0.obj")
    V1, F1 = read_obj(tmp_path / "rm_s1.obj")
    assert F1.shape[0] == 4 * F0.shape[0]
    # remeshed points stay near the unit sphere
    assert abs(np.linalg.norm(V1, axis=1).mean() - 1.0) < 0.05


def test_cli_hierarchy(tmp_path, sphere_obj):
    r = run_cli(
        ["hierarchy", str(sphere_obj), "--min-coarsest", "40",
         "-o", "h.npz"],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr
    from surface_multigrid_code_tpu.solver.hierarchy import load_hierarchy

    mg = load_hierarchy(tmp_path / "h.npz")
    assert len(mg) >= 2
