"""chip_smoke.py: every phase at a tiny size on the CPU, the no-GPU exit
(also of bench.py), and (on a machine with a CUDA card) the real run."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = {
    "static_constrained": lambda: chip_smoke.phase_static_constrained(
        "ogre_sim"),
    "static_large": lambda: chip_smoke.phase_static_large(3, 4),
    "mcf": lambda: chip_smoke.phase_mcf("ogre_sim", steps=2),
    "balloon": lambda: chip_smoke.phase_balloon("icosphere:3"),
    "queries": lambda: chip_smoke.phase_queries("icosphere:4", 320, 2000),
    "sharded_static": lambda: chip_smoke.phase_sharded_static(4, ndev=4),
    "sharded_mcf": lambda: chip_smoke.phase_sharded_mcf("ogre_sim", ndev=4),
    "sharded_balloon": lambda: chip_smoke.phase_sharded_balloon(
        "icosphere:3", ndev=4),
}


@pytest.mark.parametrize("phase", list(TINY))
def test_phase_tiny_on_cpu(phase):
    rec = TINY[phase]()
    assert rec["phase"] == phase
    assert rec["checks"], "every phase compares against a reference"
    failed = [c for c in rec["checks"] if not c["ok"]]
    assert not failed, failed
    json.dumps(rec)  # the record prints as one JSON line


def _run(args, env_extra, cwd=REPO):
    env = dict(os.environ)
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=600,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_cpu_run_exits_nonzero_without_result(script):
    r = _run([os.path.join(REPO, script)], {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert not r.stdout.strip(), r.stdout[-2000:]


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=1200,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
    assert gpu_card in lines[:-1]
