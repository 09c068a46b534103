"""Device build-artifact serialization round trip (VERDICT r4 item 6):
a DeviceHierarchy (ELL operators + diagonals + coarse inverse)
saved and reloaded must reproduce the solve bit-for-bit, and the warm
path must skip host staging entirely."""

import numpy as np

import jax
import jax.numpy as jnp

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.laplacian import cotmatrix, massmatrix
from surface_multigrid_code_tpu.solver.serialize import (
    load_device_hierarchy,
    save_device_hierarchy,
)
from surface_multigrid_code_tpu.solver.vcycle import (
    build_device_hierarchy,
    solve_loop,
)
from surface_multigrid_code_tpu.utils.synthetic import subdivision_hierarchy


def _system():
    meshes, Ps = subdivision_hierarchy(4)
    V, F = meshes[0]
    A = (massmatrix(V, F) - 0.01 * cotmatrix(V, F)).tocsr()
    As = [A]
    for P in Ps:
        As.append((P.T @ As[-1] @ P).tocsr())
    rhs = np.asarray(massmatrix(V, F) @ V[:, 0])
    return As, Ps, rhs


def test_device_hierarchy_roundtrip(tmp_path):
    As, Ps, rhs = _system()
    cfg = SolveConfig(smoother=SmootherType.JACOBI)
    hier = build_device_hierarchy(As, Ps, cfg=cfg, dtype=jnp.float64)
    path = tmp_path / "hier.npz"
    save_device_hierarchy(path, hier)
    hier2 = load_device_hierarchy(path)

    # every leaf identical (arrays bitwise, aux exact)
    l1, d1 = jax.tree_util.tree_flatten(hier)
    l2, d2 = jax.tree_util.tree_flatten(hier2)
    assert d1 == d2
    for a, b in zip(l1, l2):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    b_d = jnp.asarray(rhs, dtype=jnp.float64)
    z0 = jnp.zeros_like(b_d)
    tol = jnp.asarray(0.0, jnp.float64)
    z1, r1, k1 = solve_loop(hier, b_d, z0, tol, 4, cfg)
    z2, r2, k2 = solve_loop(hier2, b_d, z0, tol, 4, cfg)
    assert int(k1) == int(k2)
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))


def test_pytree_container_roundtrip(tmp_path):
    """Generic container path: nested dict/tuple/scalars of device
    arrays (the shape of solver _state dicts)."""
    from surface_multigrid_code_tpu.solver.serialize import (
        load_pytree,
        save_pytree,
    )

    obj = {
        "a": jnp.arange(5, dtype=jnp.int32),
        "nested": (jnp.ones((2, 3)), None, ("x", 3, 2.5, True)),
        "empty": (),
    }
    p = tmp_path / "state.npz"
    save_pytree(p, obj)
    out = load_pytree(p)
    assert set(out) == set(obj)
    np.testing.assert_array_equal(np.asarray(out["a"]), np.asarray(obj["a"]))
    np.testing.assert_array_equal(
        np.asarray(out["nested"][0]), np.asarray(obj["nested"][0])
    )
    assert out["nested"][1] is None
    assert out["nested"][2] == ("x", 3, 2.5, True)
    assert out["empty"] == ()
