"""V-cycle smoothers: multi-color Gauss-Seidel and damped Jacobi.

The reference relaxes with sequential in-place Gauss-Seidel
(src/mg_VCycle.cpp:146-177): u_i = (b_i - sum_{j != i} a_ij u_j) / a_ii,
consuming already-updated entries. Sequential sweeps are the wrong shape for
a data-parallel device; the idiomatic equivalent is *multi-color* Gauss-Seidel: a host-side
greedy coloring partitions rows into independent sets, and within a color
every update reads only other-color entries, so one sweep = a few
constant-shape masked Jacobi-style updates with identical convergence
character to lexicographic GS.

Damped Jacobi (w = 2/3 default) is also provided; it is a single fused
SpMV + axpy, the fastest per-sweep option.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from surface_multigrid_code_tpu.ops.sparse import HIGHEST, ELLMatrix, ell_spmv


def greedy_coloring(A: sp.spmatrix) -> np.ndarray:
    """Greedy graph coloring of A's sparsity (host, once per hierarchy).

    Returns int array color[n]. Rows sharing a structural nonzero (off the
    diagonal) never share a color. Cotan Laplacians (~7 nnz/row) typically
    need 5-8 colors.  Runs in the native engine; NumPy fallback kept for
    environments without a C++ toolchain.
    """
    A = A.tocsr()
    try:
        from surface_multigrid_code_tpu.ssp._native import greedy_coloring_csr

        return greedy_coloring_csr(A.indptr, A.indices)
    except Exception:
        pass
    n = A.shape[0]
    color = np.full(n, -1, dtype=np.int32)
    indptr, indices = A.indptr, A.indices
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        nb = indices[lo:hi]
        used = set(color[j] for j in nb if j != i and color[j] >= 0)
        c = 0
        while c in used:
            c += 1
        color[i] = c
    return color


def color_groups(color: np.ndarray, pad_to_multiple: int = 8) -> list[np.ndarray]:
    """Row-index arrays per color, padded (by repeating the last row) so
    group sizes are stable multiples — keeps XLA happy across refreshes."""
    groups = []
    for c in range(int(color.max(initial=-1)) + 1):
        idx = np.nonzero(color == c)[0].astype(np.int32)
        if pad_to_multiple > 1 and idx.size % pad_to_multiple:
            pad = pad_to_multiple - idx.size % pad_to_multiple
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
        groups.append(idx)
    return groups


def group_scales(groups: list[np.ndarray], dtype=np.float64) -> list[np.ndarray]:
    """Per-entry 1/multiplicity for padded (duplicated) group rows, so a
    duplicated row's repeated scatter-add collapses to one GS update."""
    out = []
    for g in groups:
        _, inv, counts = np.unique(g, return_inverse=True, return_counts=True)
        out.append((1.0 / counts[inv]).astype(dtype))
    return out


def multicolor_gs_sweep(
    A: ELLMatrix,
    diag: jnp.ndarray,
    groups: tuple[jnp.ndarray, ...],
    group_scale: tuple[jnp.ndarray, ...],
    b: jnp.ndarray,
    u: jnp.ndarray,
) -> jnp.ndarray:
    """One multi-color GS sweep: per color, u[c] += scale * (b - A u)[c] / d[c].

    group_scale carries 1/multiplicity for padded (duplicated) rows so a
    duplicated row's double-update collapses to a single GS update.
    """
    for idx, scale in zip(groups, group_scale):
        rows_idx = A.indices[idx]
        rows_dat = A.data[idx]
        gathered = u[rows_idx]
        if u.ndim == 1:
            Au = (rows_dat * gathered).sum(axis=1)
            r = b[idx] - Au
            u = u.at[idx].add(scale * r / diag[idx])
        else:
            Au = jnp.einsum(
                "nw,nwr->nr", rows_dat, gathered, precision=HIGHEST
            )
            r = b[idx] - Au
            u = u.at[idx].add((scale / diag[idx])[:, None] * r)
    return u


def chebyshev_smooth(
    A: ELLMatrix,
    diag: jnp.ndarray,
    lam_max,
    b: jnp.ndarray,
    u: jnp.ndarray,
    degree: int = 2,
    lam_ratio: float = 4.0,
) -> jnp.ndarray:
    """Chebyshev-accelerated Jacobi smoothing of given polynomial degree.

    Damps the error on the D^-1 A spectrum interval
    [lam_max / lam_ratio, lam_max] — the standard multigrid Chebyshev
    smoother (Adams et al.).  Per step it is one SpMV + axpys, no masked
    scatters: the bandwidth-optimal smoother shape, and unlike
    Gauss-Seidel it is order-independent so it shards cleanly.
    """
    lam_min = lam_max / lam_ratio
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)

    def dinv(v):
        return v / diag if v.ndim == 1 else v / diag[:, None]

    r = dinv(b - ell_spmv(A, u))
    alpha = 1.0 / theta
    d = alpha * r
    u = u + d
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = dinv(b - ell_spmv(A, u))
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        u = u + d
        rho = rho_new
    return u


def jacobi_sweep(
    A: ELLMatrix,
    diag: jnp.ndarray,
    b: jnp.ndarray,
    u: jnp.ndarray,
    weight: float = 2.0 / 3.0,
) -> jnp.ndarray:
    """One damped-Jacobi sweep: u += w * D^-1 (b - A u)."""
    r = b - ell_spmv(A, u)
    if u.ndim == 1:
        return u + weight * r / diag
    return u + weight * r / diag[:, None]
