"""Multi-chip row-partitioned multigrid (SPMD over a 1-D device mesh).

The reference is single-process CPU code (SURVEY.md §2.8) — this module is
new design, the domain analog of tensor/sequence parallelism: every level's
matrix rows (mesh vertices) are partitioned into contiguous blocks across a
1-D `jax.sharding.Mesh` axis ("rows"), vectors are sharded the same way,
and the jitted V-cycle runs under GSPMD, which inserts the gather/reduce
collectives for the off-block vector entries (the 1-ring / P-stencil halo)
between devices.  The coarsest level's dense pseudo-inverse is replicated.

Row counts are padded per level to a multiple of the axis size with
identity rows (diag 1, rhs 0), so all blocks are equal-shape and XLA sees
static shapes.  The smoother for the sharded path is damped Jacobi — one
fused SpMV + axpy per sweep, the bandwidth-optimal shape at scale — rather
than multi-color Gauss-Seidel whose color groups shard irregularly.

ROLE: the simplest sharding spec and the GSPMD cross-check of the
hand-scheduled halo exchange in parallel/halo.py, which the sharded
steppers use.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.sparse import ELLMatrix, ell_from_csr
from surface_multigrid_code_tpu.solver.vcycle import (
    DeviceHierarchy,
    DeviceLevel,
    _power_iteration_lam_max,
    solve_loop,
)


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _pad_matrix(A: sp.spmatrix, nr: int, nc: int, identity_pad: bool) -> sp.csr_matrix:
    """Embed A into an nr x nc matrix; optionally put 1 on padded diagonal."""
    A = A.tocoo()
    rows, cols, vals = [A.row], [A.col], [A.data]
    if identity_pad:
        extra = np.arange(A.shape[0], min(nr, nc))
        rows.append(extra)
        cols.append(extra)
        vals.append(np.ones(extra.shape[0]))
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nr, nc),
    ).tocsr()


def build_sharded_hierarchy(
    As: list[sp.spmatrix],
    Ps: list[sp.spmatrix],
    mesh: Mesh,
    cfg: SolveConfig | None = None,
    dtype=jnp.float32,
) -> tuple[DeviceHierarchy, list[int]]:
    """Shard a Galerkin hierarchy over mesh axis "rows".

    As: per-level Galerkin matrices (finest first), Ps[l]: level l+1 -> l.
    Returns (hierarchy, padded_sizes).  The returned hierarchy is a normal
    DeviceHierarchy whose leaves carry NamedShardings — the single-device
    jitted V-cycle (solver/vcycle.py) runs on it unchanged under GSPMD.
    cfg: a Chebyshev smoother gets each level's lam_max(D^-1 A) bound from
    the unpadded operator (the same estimate parallel/halo.py uses).
    """
    ndev = mesh.shape["rows"]
    row_sharded = NamedSharding(mesh, P("rows", None))
    vec_sharded = NamedSharding(mesh, P("rows"))
    replicated = NamedSharding(mesh, P())

    L = len(As)
    sizes = [_pad_to(A.shape[0], ndev) for A in As]
    levels = []
    for lv in range(L):
        Ap = _pad_matrix(As[lv], sizes[lv], sizes[lv], identity_pad=True)
        diag = Ap.diagonal()
        ell = ell_from_csr(Ap, dtype=dtype)
        ell = ELLMatrix(
            indices=jax.device_put(ell.indices, row_sharded),
            data=jax.device_put(ell.data, row_sharded),
            n_cols=sizes[lv],
        )
        if lv == 0:
            Pm = PT = None
        else:
            Pp = _pad_matrix(Ps[lv - 1], sizes[lv - 1], sizes[lv], identity_pad=False)
            pe = ell_from_csr(Pp, dtype=dtype)
            Pm = ELLMatrix(
                indices=jax.device_put(pe.indices, row_sharded),
                data=jax.device_put(pe.data, row_sharded),
                n_cols=sizes[lv],
            )
            pte = ell_from_csr(Pp.T.tocsr(), dtype=dtype)
            PT = ELLMatrix(
                indices=jax.device_put(pte.indices, row_sharded),
                data=jax.device_put(pte.data, row_sharded),
                n_cols=sizes[lv - 1],
            )
        lam_max = None
        if cfg is not None and cfg.smoother == SmootherType.CHEBYSHEV:
            lam_max = jnp.asarray(
                _power_iteration_lam_max(As[lv].tocsr()), dtype=dtype
            )
        levels.append(
            DeviceLevel(
                A=ell,
                diag=jax.device_put(jnp.asarray(diag, dtype=dtype), vec_sharded),
                P=Pm,
                PT=PT,
                groups=(),
                group_scale=(),
                lam_max=lam_max,
            )
        )
    Ac = np.asarray(
        _pad_matrix(As[-1], sizes[-1], sizes[-1], identity_pad=True).todense()
    )
    Ac = 0.5 * (Ac + Ac.T)
    w, U = np.linalg.eigh(Ac)
    cutoff = 1e-10 * float(np.abs(w).max())
    inv_w = np.where(np.abs(w) > cutoff, 1.0 / np.where(w == 0, 1.0, w), 0.0)
    Cinv = (U * inv_w) @ U.T
    hier = DeviceHierarchy(
        levels=tuple(levels),
        coarse_inv=jax.device_put(jnp.asarray(Cinv, dtype=dtype), replicated),
    )
    return hier, sizes


def sharded_solve(
    hier: DeviceHierarchy,
    sizes: list[int],
    mesh: Mesh,
    rhs: np.ndarray,
    z0: np.ndarray | None = None,
    tolerance: float = 1e-3,
    max_iter: int = 20,
    cfg: SolveConfig | None = None,
    dtype=jnp.float32,
):
    """Run the jitted V-cycle iteration on a row-sharded hierarchy.

    rhs may be (n,) or (n, k); it is padded to sizes[0] and sharded.
    Returns (z, r_his, iters) with z cropped back to n rows.
    """
    cfg = cfg or SolveConfig(smoother=SmootherType.JACOBI)
    n = rhs.shape[0]
    pad = sizes[0] - n
    rhs_p = np.pad(np.asarray(rhs, dtype=np.float64), [(0, pad)] + [(0, 0)] * (rhs.ndim - 1))
    z0_p = (
        np.zeros_like(rhs_p)
        if z0 is None
        else np.pad(np.asarray(z0, dtype=np.float64), [(0, pad)] + [(0, 0)] * (rhs.ndim - 1))
    )
    vec_spec = P("rows") if rhs.ndim == 1 else P("rows", None)
    sh = NamedSharding(mesh, vec_spec)
    rhs_d = jax.device_put(jnp.asarray(rhs_p, dtype=dtype), sh)
    z0_d = jax.device_put(jnp.asarray(z0_p, dtype=dtype), sh)
    z, r_his, k = solve_loop(
        hier, rhs_d, z0_d, jnp.asarray(tolerance, dtype=dtype), int(max_iter), cfg
    )
    k = int(k)
    return np.asarray(z)[:n], [float(r) for r in np.asarray(r_his)[:k]], k


def make_row_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("rows",))
