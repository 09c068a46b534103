"""Opt-in end-to-end runs of every example script (pytest -m slow).

The fast suite covers every component; these execute the actual example
drivers as subprocesses on the bundled meshes — the closest analog of the
reference's examples-as-integration-tests quality control (SURVEY.md §4).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

ALL = [
    "ex01_single_ssp.py",
    "ex02_mg_hierarchy.py",
    "ex03_mg_solver.py",
    "ex04_mg_solver_nobd.py",
    "ex05_mean_curvature_flow.py",
    "ex06_balloon_sim.py",
    "ex07_coarse_to_fine.py",
    "ex08_subdiv_remesh.py",
    "ex09_random_subdiv_remesh.py",
]


@pytest.mark.slow
@pytest.mark.parametrize("script", ALL)
def test_example_runs(script):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script)],
        cwd=EXAMPLES, env=env, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-2000:]
