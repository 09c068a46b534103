"""Per-face PSD projection (models/shell.psd_project_blocks) against a
numpy eigh clamp, for stretching (9x9) and bending (18x18) blocks."""

import numpy as np
import pytest

import jax.numpy as jnp

from surface_multigrid_code_tpu.models.shell import psd_project_blocks


def _blocks(d, m=64, seed=0):
    """Symmetric blocks whose eigenvalues stay clear of the sign
    iteration's saturation threshold (|lam| / ||H||_inf >= ~1e-3), half of
    them indefinite."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((m, d, d)))
    lam = rng.uniform(0.05, 1.0, (m, d)) * rng.choice([-1.0, 1.0], (m, d))
    lam[: m // 2] = np.abs(lam[: m // 2])  # PSD half passes unchanged
    scale = 10.0 ** rng.uniform(-3, 3, (m, 1, 1))
    return scale * np.einsum("mij,mj,mkj->mik", Q, lam, Q)


def _eigh_clamp(H):
    w, U = np.linalg.eigh(H)
    return np.einsum("mij,mj,mkj->mik", U, np.maximum(w, 0.0), U)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("d", [9, 18])
def test_psd_projection_matches_eigh_clamp(d, dtype):
    H = _blocks(d)
    out = np.asarray(psd_project_blocks(jnp.asarray(H, dtype=dtype)),
                     dtype=np.float64)
    ref = _eigh_clamp(H)
    s = np.abs(H).sum(-1).max(-1)[:, None, None]
    # 25 dependent products at HIGHEST: a few hundred ulps of ||H||
    tol = 2e-4 if dtype == jnp.float32 else 1e-11
    assert np.abs(out - ref).max(axis=(1, 2)).max() <= tol * s.max()
    assert (np.abs(out - ref) <= tol * s).all()
    # PSD blocks pass through bitwise (in the working dtype)
    half = H.shape[0] // 2
    np.testing.assert_array_equal(
        out[:half], np.asarray(jnp.asarray(H[:half], dtype=dtype),
                               dtype=np.float64))
