"""Explicit halo-exchange multigrid over a 1-D device mesh (shard_map).

This is the multi-device path of the sharded steppers (parallel/mcf.py,
parallel/balloon.py), including the sharded value refresh.

parallel/spmd.py lets GSPMD insert collectives automatically; this module
is the hand-scheduled version: every level's rows are partitioned into
equal contiguous blocks, and each SpMV exchanges ONLY the halo — the
vector entries other devices actually reference (the 1-ring / P-stencil
boundary, SURVEY.md §5.7).

Plan (host, once per hierarchy):
  - per level, per device: `send` = sorted local row ids referenced by any
    other device's stencil, padded to the per-level max;
  - every matrix's column ids are remapped into the device-local address
    space [0, R + D*S): the first R entries are the local x block, the rest
    index the all-gathered publish buffer.

Runtime (inside one shard_map over axis "rows"):
    published = all_gather(x_local[send_local])       # [D, S] -> flat
    xx = concat(x_local, published)                   # local address space
    y_local = ELL-SpMV(A_local, xx)
so each level's SpMV costs exactly one all-gather of its halo (thin:
O(boundary) not O(n)), and smoothing stays order-free (Jacobi/Chebyshev).
The coarsest level is gathered and solved replicated with the dense
pseudo-inverse, then sliced back.
"""

from __future__ import annotations

from dataclasses import dataclass


import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from surface_multigrid_code_tpu.config import SolveConfig, SmootherType
from surface_multigrid_code_tpu.ops.sparse import HIGHEST


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _ell_arrays(A: sp.csr_matrix, n_rows: int, width_min: int = 1,
                src_base: int | None = None):
    """Padded ELL (indices, data) for the first n_rows rows of A.

    With src_base, also returns the source nnz id of each slot
    (src_base + position in A's CSR order; -1 for ELL padding) — used by
    the refreshable path to regather values per solve."""
    A = A.tocsr()
    counts = np.diff(A.indptr)
    width = max(int(counts.max(initial=0)), width_min)
    idx = np.zeros((n_rows, width), dtype=np.int64)
    dat = np.zeros((n_rows, width), dtype=np.float64)
    rows = np.repeat(np.arange(A.shape[0]), counts)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    idx[rows, slots] = A.indices
    dat[rows, slots] = A.data
    if src_base is None:
        return idx, dat
    src = np.full((n_rows, width), -1, dtype=np.int64)
    src[rows, slots] = src_base + np.arange(A.nnz)
    return idx, dat, src


@dataclass
class HaloLevelHost:
    """Host-side per-level plan before device upload."""

    R: int                      # rows per device
    S: int                      # publish slots per device
    send: np.ndarray            # [D, S] local row ids each device publishes
    A_idx: np.ndarray           # [D*R, w] local-address column ids
    A_dat: np.ndarray
    diag: np.ndarray            # [D*R]
    # P maps this level (coarse, cols) to finer level (rows); stored on the
    # FINER level's partition; PT on this level's partition
    P_idx: np.ndarray | None
    P_dat: np.ndarray | None
    PT_idx: np.ndarray | None
    PT_dat: np.ndarray | None
    lam_max: float


def _remap_columns(cols: np.ndarray, D: int, R: int, send_lists, dev: int):
    """Global column id -> device-local address for device `dev`.

    Local rows [dev*R, (dev+1)*R) -> [0, R); any other referenced row must
    appear in its owner's send list -> R + owner*S + slot.
    """
    out = np.empty_like(cols)
    owner = cols // R
    local = owner == dev
    out[local] = cols[local] - dev * R
    S = send_lists.shape[1]
    for od in range(D):
        m = (~local) & (owner == od)
        if not m.any():
            continue
        want = cols[m] - od * R
        slot = np.minimum(np.searchsorted(send_lists[od], want), S - 1)
        if not np.all(send_lists[od][slot] == want):
            raise ValueError(
                f"column remap: rows {np.unique(want[send_lists[od][slot] != want])[:8]}"
                f" referenced by device {dev} are missing from device {od}'s"
                " halo send list"
            )
        out[m] = R + od * S + slot
    return out


def _build_level(A: sp.csr_matrix, D: int, extra_row_refs=None):
    """Partition one level: returns (R, send [D,S], remap function data).

    extra_row_refs: additional (row-referencing) matrices whose stencils
    also read this level's vector (e.g. P reading the coarse vector) —
    their column references are included in the halo sets.
    """
    n = A.shape[0]
    R = _pad_to(n, D) // D
    n_pad = R * D
    Ap = sp.csr_matrix(A, copy=True)
    Ap.resize((n_pad, n_pad))
    # collect, per owner device, the set of rows referenced by OTHER devices
    need: list[set] = [set() for _ in range(D)]

    def collect(M: sp.csr_matrix, row_of_block):
        M = M.tocsr()
        for d in range(D):
            lo, hi = row_of_block(d)
            cols = M.indices[M.indptr[min(lo, M.shape[0])] : M.indptr[min(hi, M.shape[0])]]
            for od in np.unique(cols // R):
                if od == d:
                    continue
                sel = cols[cols // R == od]
                need[od].update((sel - od * R).tolist())

    collect(Ap, lambda d: (d * R, (d + 1) * R))
    if extra_row_refs:
        for M in extra_row_refs:
            Mp = sp.csr_matrix(M, copy=True)
            Mp.resize((_pad_to(M.shape[0], D), n_pad))
            RM = Mp.shape[0] // D
            collect(Mp, lambda d: (d * RM, (d + 1) * RM))
    S = max(1, max(len(s) for s in need))
    send = np.zeros((D, S), dtype=np.int64)
    for d in range(D):
        ids = np.sort(np.fromiter(need[d], dtype=np.int64, count=len(need[d])))
        send[d, : ids.shape[0]] = ids
        if ids.shape[0] < S:
            send[d, ids.shape[0] :] = ids[-1] if ids.shape[0] else 0
    return Ap, R, send


class HaloHierarchy:
    """Sharded hierarchy + jitted shard_map solve."""

    def __init__(
        self,
        As: list[sp.spmatrix],
        Ps: list[sp.spmatrix],
        mesh: Mesh,
        cfg: SolveConfig | None = None,
        dtype=jnp.float32,
        reorder: bool = True,
    ):
        self.mesh = mesh
        self.cfg = cfg or SolveConfig(smoother=SmootherType.CHEBYSHEV)
        self.dtype = dtype
        D = mesh.shape["rows"]
        self.D = D
        L = len(As)
        self.n0 = As[0].shape[0]

        # Locality reordering (SURVEY.md §7 M6): contiguous row blocks are
        # only halo-thin if the vertex ordering is spatially coherent —
        # e.g. subdivision meshes interleave levels and make every block
        # boundary-adjacent to every other.  Reverse Cuthill-McKee per level
        # shrinks the halo to the O(separator) it should be; vectors are
        # permuted on entry and inverse-permuted on exit.
        A0_orig = As[0].tocsr().copy()
        A0_orig.sum_duplicates()
        self._A0_orig = A0_orig
        self._refresh_state = None
        self.perm0 = np.arange(self.n0)
        if reorder:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perms = [
                np.asarray(reverse_cuthill_mckee(A.tocsr(), symmetric_mode=True))
                for A in As
            ]
            As = [
                A.tocsr()[perms[lv]][:, perms[lv]].tocsr()
                for lv, A in enumerate(As)
            ]
            Ps = [
                P.tocsr()[perms[lv]][:, perms[lv + 1]].tocsr()
                for lv, P in enumerate(Ps)
            ]
            self.perm0 = perms[0]
        for A in As:
            A.sum_duplicates()
        # bookkeeping for the refreshable path (populated in the level loop)
        self._A_srcs: list[np.ndarray] = []
        self._diag_srcs: list[np.ndarray] = []
        self._level_nnz: list[int] = []
        self._As_perm = As
        self._Ps_perm = Ps
        self._sm_cache: dict = {}

        host_levels: list[HaloLevelHost] = []
        for lv in range(L):
            A = As[lv].tocsr()
            # This level's vector is read by: its A stencil, PT_lv (coarse
            # rows reading fine entries during restriction), and P_{lv-1}
            # (finer rows reading THIS level's entries during prolongation).
            extra = []
            if lv < L - 1:
                extra.append(Ps[lv].T.tocsr())  # coarse rows reading fine cols
            if lv > 0:
                extra.append(Ps[lv - 1].tocsr())  # finer rows reading our cols
            Ap, R, send = _build_level(A, D, extra_row_refs=extra)
            S = send.shape[1]
            n_pad = R * D
            # identity-pad rows beyond n
            n = A.shape[0]
            if n_pad > n:
                pad = np.arange(n, n_pad)
                # append identity rows STRUCTURALLY — scipy sparse addition
                # prunes explicitly-stored zero entries, which would shift
                # every subsequent A_src nnz id (balloon Hessians carry
                # exact zeros at rest; found via diverging refreshed solves)
                indptr = Ap.indptr.copy()
                indptr[n + 1 :] = indptr[n] + np.arange(1, n_pad - n + 1)
                Ap = sp.csr_matrix(
                    (
                        np.concatenate([Ap.data, np.ones(n_pad - n)]),
                        np.concatenate([Ap.indices, pad]),
                        indptr,
                    ),
                    shape=(n_pad, n_pad),
                )
            diag = Ap.diagonal()
            # per-device remapped ELL (+ source nnz ids for the refreshable
            # path: ids >= A.nnz are identity-pad entries, -1 is ELL padding)
            idxs, dats, srcs = [], [], []
            w = None
            for d in range(D):
                blk = Ap[d * R : (d + 1) * R]
                bi, bd, bs = _ell_arrays(
                    blk, R, src_base=int(Ap.indptr[d * R])
                )
                # structural padding only (bs == -1): a REAL stored entry
                # whose current value happens to be 0.0 must keep its src
                # id, or its refreshed values would be dropped forever
                bi[bs == -1] = d * R  # padding -> any LOCAL row (weight 0)
                bi = _remap_columns(bi.reshape(-1), D, R, send, d).reshape(bi.shape)
                idxs.append(bi)
                dats.append(bd)
                srcs.append(bs)
                w = bi.shape[1] if w is None else max(w, bi.shape[1])
            # unify widths
            for k in range(D):
                if idxs[k].shape[1] < w:
                    padw = w - idxs[k].shape[1]
                    idxs[k] = np.pad(idxs[k], [(0, 0), (0, padw)])
                    dats[k] = np.pad(dats[k], [(0, 0), (0, padw)])
                    srcs[k] = np.pad(
                        srcs[k], [(0, 0), (0, padw)], constant_values=-1
                    )
            A_idx = np.concatenate(idxs)
            A_dat = np.concatenate(dats)
            A_src = np.concatenate(srcs)
            # encode identity-pad entries (value fixed at 1.0) as -2
            A_src[A_src >= A.nnz] = -2
            diag_src = np.full(n_pad, -2, dtype=np.int64)
            prows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
            pkeys = prows * n + A.indices
            dkeys = np.arange(n, dtype=np.int64) * (n + 1)
            pos = np.searchsorted(pkeys, dkeys)
            has = (pos < pkeys.size) & (
                pkeys[np.minimum(pos, pkeys.size - 1)] == dkeys
            )
            diag_src[np.flatnonzero(has)] = pos[has]
            self._A_srcs.append(A_src)
            self._diag_srcs.append(diag_src)
            self._level_nnz.append(int(A.nnz))
            lam = 0.0
            if self.cfg.smoother == SmootherType.CHEBYSHEV:
                from surface_multigrid_code_tpu.solver.vcycle import (
                    _power_iteration_lam_max,
                )

                lam = _power_iteration_lam_max(As[lv].tocsr())
            host_levels.append(
                HaloLevelHost(
                    R=R, S=S, send=send, A_idx=A_idx, A_dat=A_dat, diag=diag,
                    P_idx=None, P_dat=None, PT_idx=None, PT_dat=None,
                    lam_max=lam,
                )
            )
        # transfer operators: P on fine partition (rows), columns COARSE
        # (read via the coarse level's halo space); PT on coarse partition,
        # columns FINE (read via fine level's halo space)
        for lv in range(L - 1):
            fine, coarse = host_levels[lv], host_levels[lv + 1]
            Pmat = Ps[lv].tocsr()
            Pp = sp.csr_matrix(Pmat, copy=True)
            Pp.resize((fine.R * D, coarse.R * D))
            idxs, dats = [], []
            w = None
            for d in range(D):
                blk = Pp[d * fine.R : (d + 1) * fine.R]
                bi, bd = _ell_arrays(blk, fine.R)
                bi[bd == 0] = d * coarse.R  # padding -> local coarse row
                bi = _remap_columns(
                    bi.reshape(-1), D, coarse.R, coarse.send, d
                ).reshape(bi.shape)
                idxs.append(bi)
                dats.append(bd)
                w = bi.shape[1] if w is None else max(w, bi.shape[1])
            for k in range(D):
                if idxs[k].shape[1] < w:
                    padw = w - idxs[k].shape[1]
                    idxs[k] = np.pad(idxs[k], [(0, 0), (0, padw)])
                    dats[k] = np.pad(dats[k], [(0, 0), (0, padw)])
            host_levels[lv].P_idx = np.concatenate(idxs)
            host_levels[lv].P_dat = np.concatenate(dats)
            PT = Pmat.T.tocsr()
            PTp = sp.csr_matrix(PT, copy=True)
            PTp.resize((coarse.R * D, fine.R * D))
            idxs, dats = [], []
            w = None
            for d in range(D):
                blk = PTp[d * coarse.R : (d + 1) * coarse.R]
                bi, bd = _ell_arrays(blk, coarse.R)
                bi[bd == 0] = d * fine.R  # padding -> local fine row
                bi = _remap_columns(
                    bi.reshape(-1), D, fine.R, fine.send, d
                ).reshape(bi.shape)
                idxs.append(bi)
                dats.append(bd)
                w = bi.shape[1] if w is None else max(w, bi.shape[1])
            for k in range(D):
                if idxs[k].shape[1] < w:
                    padw = w - idxs[k].shape[1]
                    idxs[k] = np.pad(idxs[k], [(0, 0), (0, padw)])
                    dats[k] = np.pad(dats[k], [(0, 0), (0, padw)])
            host_levels[lv].PT_idx = np.concatenate(idxs)
            host_levels[lv].PT_dat = np.concatenate(dats)

        # coarsest dense pseudo-inverse (replicated)
        nL = host_levels[-1].R * D
        Ac = sp.csr_matrix(As[-1], copy=True)
        Ac.resize((nL, nL))
        n_last = As[-1].shape[0]
        if nL > n_last:
            pad = np.arange(n_last, nL)
            Ac = (Ac + sp.coo_matrix(
                (np.ones(pad.shape[0]), (pad, pad)), shape=(nL, nL)
            )).tocsr()
        Acd = 0.5 * (Ac.toarray() + Ac.toarray().T)
        wv, U = np.linalg.eigh(Acd)
        cutoff = 1e-10 * float(np.abs(wv).max())
        inv_w = np.where(np.abs(wv) > cutoff, 1.0 / np.where(wv == 0, 1, wv), 0.0)
        Cinv = (U * inv_w) @ U.T

        # upload: row-sharded leaves
        shard = NamedSharding(mesh, P("rows", None))
        vec = NamedSharding(mesh, P("rows"))
        rep = NamedSharding(mesh, P())
        put = jax.device_put
        self.levels = []
        for lv_i, hl in enumerate(host_levels):
            self.levels.append(
                dict(
                    R=hl.R,
                    S=hl.S,
                    A_src=put(jnp.asarray(self._A_srcs[lv_i]), shard),
                    diag_src=put(jnp.asarray(self._diag_srcs[lv_i]), vec),
                    send=put(jnp.asarray(hl.send), shard),
                    A_idx=put(jnp.asarray(hl.A_idx, dtype=jnp.int32), shard),
                    A_dat=put(jnp.asarray(hl.A_dat, dtype=dtype), shard),
                    diag=put(jnp.asarray(hl.diag, dtype=dtype), vec),
                    P_idx=None if hl.P_idx is None else put(
                        jnp.asarray(hl.P_idx, dtype=jnp.int32), shard
                    ),
                    P_dat=None if hl.P_dat is None else put(
                        jnp.asarray(hl.P_dat, dtype=dtype), shard
                    ),
                    PT_idx=None if hl.PT_idx is None else put(
                        jnp.asarray(hl.PT_idx, dtype=jnp.int32), shard
                    ),
                    PT_dat=None if hl.PT_dat is None else put(
                        jnp.asarray(hl.PT_dat, dtype=dtype), shard
                    ),
                    lam_max=jnp.asarray(hl.lam_max, dtype=dtype),
                )
            )
        self.coarse_inv = put(jnp.asarray(Cinv, dtype=dtype), rep)
        self._solve_jit = None
        self._plan = None  # built lazily by enable_refresh()
        self._n_last = As[-1].shape[0]
        self._coarse_shift = 1e-12

    # ------------------------------------------------------------------
    def _shard_body(self, lvl_args, coarse_inv, rhs_l, z_l, tol, max_iter, Rs):
        """Runs per device under shard_map.

        Local block shapes: send [1, S] (row of the [D, S] table), A_idx /
        A_dat [R, w], diag [R], vectors [R]; Rs are static ints (closure).
        """
        cfg = self.cfg

        def exchange(lv, x_l):
            # x_l: [R] or [R, k]; publish buffer gathers along the row axis
            send = lvl_args[lv]["send"][0]      # local [S]
            pub = x_l[send]                     # [S] / [S, k]
            allpub = jax.lax.all_gather(pub, "rows")  # [D, S] / [D, S, k]
            flat = allpub.reshape((-1,) + x_l.shape[1:])
            return jnp.concatenate([x_l, flat])

        def spmv(idx, dat, xx):
            g = xx[idx]                         # [R, w] or [R, w, k]
            if g.ndim == 2:
                return (dat * g).sum(axis=1)
            return jnp.einsum("rw,rwk->rk", dat, g, precision=HIGHEST)

        def Ax(lv, x_l):
            xx = exchange(lv, x_l)
            return spmv(lvl_args[lv]["A_idx"], lvl_args[lv]["A_dat"], xx)

        def dinv(lv, v):
            diag = lvl_args[lv]["diag"]
            return v / diag if v.ndim == 1 else v / diag[:, None]

        def smooth(lv, b_l, u_l, n_iter):
            if cfg.smoother == SmootherType.CHEBYSHEV:
                lam_max = lvl_args[lv]["lam_max"]
                lam_min = lam_max / 4.0
                theta = 0.5 * (lam_max + lam_min)
                delta = 0.5 * (lam_max - lam_min)
                r = dinv(lv, b_l - Ax(lv, u_l))
                d = r / theta
                u_l = u_l + d
                sigma = theta / delta
                rho = 1.0 / sigma
                for _ in range(n_iter - 1):
                    rho_new = 1.0 / (2.0 * sigma - rho)
                    r = dinv(lv, b_l - Ax(lv, u_l))
                    d = rho_new * rho * d + (2.0 * rho_new / delta) * r
                    u_l = u_l + d
                    rho = rho_new
                return u_l
            for _ in range(n_iter):
                u_l = u_l + cfg.jacobi_weight * dinv(lv, b_l - Ax(lv, u_l))
            return u_l

        L = len(lvl_args)

        def vcycle(lv, b_l, u_l):
            if lv == L - 1:
                # replicate the coarse rhs, dense solve, slice back
                b_all = jax.lax.all_gather(b_l, "rows")
                b_all = b_all.reshape((-1,) + b_l.shape[1:])
                u_all = jnp.matmul(coarse_inv, b_all, precision=HIGHEST)
                me = jax.lax.axis_index("rows")
                R = Rs[lv]
                if b_l.ndim == 1:
                    return u_l + jax.lax.dynamic_slice(u_all, (me * R,), (R,))
                zero = jnp.zeros((), dtype=me.dtype)
                return u_l + jax.lax.dynamic_slice(
                    u_all, (me * R, zero), (R, b_l.shape[1])
                )
            u_l = smooth(lv, b_l, u_l, cfg.pre_relax_iter)
            r_l = b_l - Ax(lv, u_l)
            # restrict: PT lives on the coarse partition, reads fine halo
            rr = exchange(lv, r_l)
            rc = spmv(lvl_args[lv]["PT_idx"], lvl_args[lv]["PT_dat"], rr)
            uc = jnp.zeros_like(rc)
            uc = vcycle(lv + 1, rc, uc)
            ucx = exchange(lv + 1, uc)
            u_l = u_l + spmv(lvl_args[lv]["P_idx"], lvl_args[lv]["P_dat"], ucx)
            u_l = smooth(lv, b_l, u_l, cfg.post_relax_iter)
            return u_l

        def resid_norm(z_l):
            r = rhs_l - Ax(0, z_l)
            s = jax.lax.psum((r * r).sum(), "rows")
            return jnp.sqrt(s)

        def cond(state):
            k, _, _, done = state
            return jnp.logical_and(~done, k < max_iter)

        def body(state):
            k, z_l, r_his, _ = state
            res = resid_norm(z_l)
            r_his = r_his.at[k].set(res)
            done = res < tol
            z_new = vcycle(0, rhs_l, z_l)
            z_l = jnp.where(done, z_l, z_new)
            return (k + 1, z_l, r_his, done)

        r_his0 = jnp.full((max_iter,), -1.0, dtype=rhs_l.dtype)
        k, z_l, r_his, _ = jax.lax.while_loop(
            cond, body, (0, z_l, r_his0, jnp.asarray(False))
        )
        return z_l, r_his, k

    def _lvl_args(self):
        return [
            {
                k: v
                for k, v in lv.items()
                if k not in ("R", "S", "A_src", "diag_src") and v is not None
            }
            for lv in self.levels
        ]

    def _get_sm(self, max_iter: int, ndim: int, refreshed: bool):
        """Cached jitted solve program for a given static configuration."""
        key = (max_iter, ndim, refreshed)
        if key in self._sm_cache:
            return self._sm_cache[key]
        try:
            from jax import shard_map
        except ImportError:  # older jax
            from jax.experimental.shard_map import shard_map

        Rs = [lv["R"] for lv in self.levels]
        vspec = P("rows") if ndim == 1 else P("rows", None)

        def spec_of(v):
            if v.ndim == 0:
                return P()
            if v.ndim == 1:
                return P("rows")
            return P(*(("rows",) + (None,) * (v.ndim - 1)))

        def body(args, rhs_l, z_l, tol):
            lvls, cinv = args
            return self._shard_body(lvls, cinv, rhs_l, z_l, tol, max_iter, Rs)

        example_args = (self._lvl_args(), self.coarse_inv)
        arg_specs = jax.tree_util.tree_map(spec_of, example_args)
        kwargs = dict(
            mesh=self.mesh,
            in_specs=(arg_specs, vspec, vspec, P()),
            out_specs=(vspec, P(), P()),
        )
        try:
            sm = shard_map(body, check_vma=False, **kwargs)
        except TypeError:  # older API spelling
            sm = shard_map(body, check_rep=False, **kwargs)

        if not refreshed:
            fn = jax.jit(sm)
        else:
            from surface_multigrid_code_tpu.solver.galerkin import refresh_values

            def refreshed_solve(rstate, A0_vals, args, rhs_p, z0_p, tol):
                lvls, _ = args
                vals0 = A0_vals[rstate["perm_nnz"]]
                level_vals = refresh_values(
                    rstate["plan"], vals0.astype(self.dtype), raw=True
                )
                new_lvls = []
                for lv, (la, src, dsrc, v) in enumerate(
                    zip(lvls, rstate["A_src"], rstate["diag_src"], level_vals)
                ):
                    la = dict(la)
                    safe = jnp.clip(src, 0, v.shape[0] - 1)
                    la["A_dat"] = jnp.where(
                        src >= 0,
                        v[safe],
                        jnp.where(src == -2, 1.0, 0.0),
                    ).astype(self.dtype)
                    la["diag"] = jnp.where(
                        dsrc >= 0, v[jnp.clip(dsrc, 0, v.shape[0] - 1)], 1.0
                    ).astype(self.dtype)
                    if (
                        self.cfg.smoother == SmootherType.CHEBYSHEV
                        and lv < len(lvls) - 1
                    ):
                        # power iteration on D^-1 A with the FRESH values
                        # (replicated scalar; matches the single-chip
                        # _device_lam_max — solver/refresh.py:325)
                        nl = self._As_perm[lv].shape[0]
                        rows_l = rstate["rows_lv"][lv]
                        cols_l = rstate["cols_lv"][lv]
                        vv = v.astype(self.dtype)
                        dfull = vv[rstate["diag_slots_lv"][lv]]

                        def pw_body(i, xl, rows_l=rows_l, cols_l=cols_l,
                                    vv=vv, dfull=dfull, nl=nl):
                            x, lam = xl
                            y = jax.ops.segment_sum(
                                vv * x[cols_l], rows_l,
                                num_segments=nl, indices_are_sorted=True,
                            ) / dfull
                            lam = jnp.linalg.norm(y)
                            return (y / lam, lam)

                        x0 = jnp.full(
                            (nl,), 1.0 / np.sqrt(nl), dtype=self.dtype
                        )
                        _, lam = jax.lax.fori_loop(
                            0, 12, pw_body,
                            (x0, jnp.asarray(1.0, dtype=self.dtype)),
                        )
                        la["lam_max"] = 1.1 * lam
                    new_lvls.append(la)
                # replicated dense coarsest + Cholesky inverse (SPD refresh
                # systems, as in solver/refresh.py)
                nLp = Rs[-1] * self.D
                dense = jnp.zeros((nLp, nLp), dtype=self.dtype)
                dense = dense.at[rstate["rowsL"], rstate["colsL"]].add(
                    level_vals[-1].astype(self.dtype)
                )
                pad_ids = jnp.arange(self._n_last, nLp)
                dense = dense.at[pad_ids, pad_ids].add(1.0)
                dense = dense + self._coarse_shift * jnp.eye(
                    nLp, dtype=self.dtype
                )
                chol = jnp.linalg.cholesky(dense)
                cinv = jax.scipy.linalg.cho_solve(
                    (chol, True), jnp.eye(nLp, dtype=self.dtype)
                )
                return sm((new_lvls, cinv), rhs_p, z0_p, tol)

            fn = jax.jit(refreshed_solve)
        self._sm_cache[key] = fn
        return fn

    def _pad_vec(self, v):
        R0 = self.levels[0]["R"]
        n_pad = R0 * self.D
        v = np.asarray(v, dtype=np.float64)
        out = np.zeros((n_pad,) + v.shape[1:])
        out[: self.n0] = v[self.perm0]
        return out

    def solve(self, rhs, z0=None, tolerance=1e-3, max_iter=20):
        rhs = np.asarray(rhs, dtype=np.float64)
        rhs_p = self._pad_vec(rhs)
        z0_p = np.zeros_like(rhs_p) if z0 is None else self._pad_vec(z0)
        fn = self._get_sm(int(max_iter), rhs.ndim, refreshed=False)
        z, r_his, k = fn(
            (self._lvl_args(), self.coarse_inv),
            jnp.asarray(rhs_p, dtype=self.dtype),
            jnp.asarray(z0_p, dtype=self.dtype),
            jnp.asarray(float(tolerance), dtype=self.dtype),
        )
        return self._finish(z, r_his, k, rhs, tolerance)

    # ------------------------------------------------------------------
    # sharded value refresh: solve with fresh finest nnz values on the
    # fixed hierarchy/partition (multi-chip analog of RefreshableMGSolver)
    # ------------------------------------------------------------------
    def enable_refresh(self):
        """Build the (permuted-pattern) Galerkin plan and value maps.

        Afterwards `solve_values(A0_vals, ...)` accepts finest nnz values in
        the ORIGINAL (pre-RCM) canonical CSR order of the A0 pattern this
        hierarchy was built from.  NOTE: the hierarchy must have been built
        from PATTERN matrices with no numerically-zero entries (zero values
        get their ELL slots rerouted during remapping)."""
        from surface_multigrid_code_tpu.solver.galerkin import (
            build_galerkin_plan,
        )
        from surface_multigrid_code_tpu.solver.refresh import csr_slot_map

        from surface_multigrid_code_tpu.solver.galerkin import plan_pattern

        A0p = self._As_perm[0]
        plan = build_galerkin_plan(A0p, self._Ps_perm)
        # the plan's symbolic pattern must equal the stored chain's — a
        # numerically-built chain (scipy PᵀAP) can silently DROP entries
        # whose products cancel exactly (SSP prolongations carry exact-zero
        # weights); such hierarchies must come from galerkin_chain()
        for lv, pl_ in enumerate(plan.levels):
            A_lv = self._As_perm[lv + 1]
            pat = plan_pattern(pl_)
            if pl_.nnz_out != A_lv.nnz or not (
                np.array_equal(pat.indptr, A_lv.indptr)
                and np.array_equal(pat.indices, A_lv.indices)
            ):
                raise ValueError(
                    f"level {lv + 1} pattern mismatch (plan {pl_.nnz_out} vs "
                    f"stored {A_lv.nnz} nnz): build the hierarchy's As with "
                    "solver.galerkin.galerkin_chain so the stored chain "
                    "keeps the full symbolic PtAP pattern"
                )
        # original CSR order -> permuted order
        A0_orig = self._A0_orig
        invp = np.empty(self.n0, dtype=np.int64)
        invp[self.perm0] = np.arange(self.n0)
        orows = np.repeat(
            np.arange(self.n0, dtype=np.int64), np.diff(A0_orig.indptr)
        )
        # slot_of_orig[k] = permuted position of original nnz k; the gather
        # needs the inverse (original id FOR each permuted slot)
        slot_of_orig = csr_slot_map(A0p, invp[orows], invp[A0_orig.indices])
        perm_nnz = np.empty_like(slot_of_orig)
        perm_nnz[slot_of_orig] = np.arange(slot_of_orig.shape[0])
        AL = self._As_perm[-1]
        rowsL = np.repeat(
            np.arange(AL.shape[0], dtype=np.int64), np.diff(AL.indptr)
        )
        # per-level COO pattern + diagonal slots (canonical nnz order) for
        # the refresh-time power iteration on lam_max(D^-1 A) — Chebyshev
        # must not smooth with the BUILD values' spectrum after a value
        # refresh, and a cheap upper BOUND (Gershgorin) is NOT safe: modes
        # pushed below the [lam/4, lam] window get amplified (observed
        # divergence 5e2 -> 3e22 on a stiff shell Hessian)
        rows_lv, cols_lv, diag_slots_lv = [], [], []
        for A_lv in self._As_perm[:-1]:
            nl = A_lv.shape[0]
            rows_lv.append(
                jnp.asarray(
                    np.repeat(np.arange(nl, dtype=np.int64), np.diff(A_lv.indptr))
                )
            )
            cols_lv.append(jnp.asarray(A_lv.indices.astype(np.int64)))
            diag_slots_lv.append(
                jnp.asarray(csr_slot_map(A_lv, np.arange(nl), np.arange(nl)))
            )
        shard = NamedSharding(self.mesh, P("rows", None))
        vec = NamedSharding(self.mesh, P("rows"))
        self._refresh_state = {
            "plan": plan,
            "perm_nnz": jnp.asarray(perm_nnz),
            "rows_lv": tuple(rows_lv),
            "cols_lv": tuple(cols_lv),
            "diag_slots_lv": tuple(diag_slots_lv),
            "rowsL": jnp.asarray(rowsL),
            "colsL": jnp.asarray(AL.indices.astype(np.int64)),
            "A_src": tuple(
                jax.device_put(jnp.asarray(s), shard) for s in self._A_srcs
            ),
            "diag_src": tuple(
                jax.device_put(jnp.asarray(s), vec) for s in self._diag_srcs
            ),
        }
        return self

    def solve_values(self, A0_vals, rhs, z0=None, tolerance=1e-3, max_iter=20):
        """Refresh all levels' values from finest nnz values + solve, in one
        jitted sharded program.  Requires enable_refresh()."""
        assert self._refresh_state is not None, "call enable_refresh() first"
        rhs = np.asarray(rhs, dtype=np.float64)
        rhs_p = self._pad_vec(rhs)
        z0_p = np.zeros_like(rhs_p) if z0 is None else self._pad_vec(z0)
        fn = self._get_sm(int(max_iter), rhs.ndim, refreshed=True)
        z, r_his, k = fn(
            self._refresh_state,
            jnp.asarray(A0_vals),
            (self._lvl_args(), self.coarse_inv),
            jnp.asarray(rhs_p, dtype=self.dtype),
            jnp.asarray(z0_p, dtype=self.dtype),
            jnp.asarray(float(tolerance), dtype=self.dtype),
        )
        return self._finish(z, r_his, k, rhs, tolerance)

    def _finish(self, z, r_his, k, rhs, tolerance):
        k = int(k)
        r_list = [float(r) for r in np.asarray(r_his)[:k]]
        z_out = np.empty((self.n0,) + rhs.shape[1:])
        z_out[self.perm0] = np.asarray(z, dtype=np.float64)[: self.n0]
        return (
            z_out,
            r_list,
            bool(r_list and r_list[-1] <= tolerance),
        )
