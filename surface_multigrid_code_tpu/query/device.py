"""Device-resident SSP query engine (vmapped walks on the accelerator).

The reference fans the per-point map walks out over CPU threads
(igl::parallel_for grain 1000, src/query_fine_to_coarse.cpp:23-127).  Here
the flattened collapse log is padded to fixed per-collapse sizes (one-ring
patches are tiny: <= ~12 vertices/faces) and every query runs the walk as
a `lax.while_loop` under `vmap` — thousands of points advance in lockstep,
with masked updates for finished lanes.

Semantics identical to the host walk (query/maps.py): forward walks apply
collapses in increasing order via the face->collapse index (decIM),
relocating UV_pre -> UV_post with the max-min-barycentric snap + clamp +
renormalize; backward walks run in decreasing order, UV_post -> UV_pre.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

BIG = jnp.int32(2**30)


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceCollapseLog:
    """Padded collapse log (pytree of device arrays)."""

    subset: jnp.ndarray     # [n, maxV] global vertex ids (-1 pad)
    uv_pre: jnp.ndarray     # [n, maxV, 2]
    uv_post: jnp.ndarray    # [n, maxV, 2]
    fuv_pre: jnp.ndarray    # [n, maxF, 3] local ids (0 pad)
    fidx_pre: jnp.ndarray   # [n, maxF] global face ids (-1 pad)
    nf_pre: jnp.ndarray     # [n]
    fuv_post: jnp.ndarray
    fidx_post: jnp.ndarray
    nf_post: jnp.ndarray
    dim: jnp.ndarray        # [nF_working, maxD] collapse ids (ascending, -1 pad)
    im_fwd: jnp.ndarray     # working vertex id -> coarse id
    fim: jnp.ndarray        # working face id -> coarse face id
    im: jnp.ndarray         # coarse vertex id -> working id
    imf: jnp.ndarray        # coarse face id -> working id

    def tree_flatten(self):
        return (
            self.subset, self.uv_pre, self.uv_post, self.fuv_pre,
            self.fidx_pre, self.nf_pre, self.fuv_post, self.fidx_post,
            self.nf_post, self.dim, self.im_fwd, self.fim, self.im, self.imf,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def pad_log(log: dict) -> DeviceCollapseLog:
    """Host: flatten CSR-offset log arrays into fixed-size padded arrays."""
    voff = log["voff"]
    n = voff.shape[0] - 1
    maxV = int(np.diff(voff).max(initial=1))

    def pad_v(flat, fill, ncol=None):
        if ncol is None:
            out = np.full((n, maxV), fill, dtype=flat.dtype)
            for k in range(n):
                seg = flat[voff[k] : voff[k + 1]]
                out[k, : seg.shape[0]] = seg
            return out
        out = np.full((n, maxV, ncol), fill, dtype=flat.dtype)
        for k in range(n):
            seg = flat[voff[k] : voff[k + 1]]
            out[k, : seg.shape[0]] = seg
        return out

    def pad_f(off, tri, fid):
        maxF = int(np.diff(off).max(initial=1))
        T = np.zeros((n, maxF, 3), dtype=np.int32)
        I = np.full((n, maxF), -1, dtype=np.int32)
        cnt = np.zeros(n, dtype=np.int32)
        for k in range(n):
            lo, hi = off[k], off[k + 1]
            T[k, : hi - lo] = tri[lo:hi]
            I[k, : hi - lo] = fid[lo:hi]
            cnt[k] = hi - lo
        return T, I, cnt

    fuv_pre, fidx_pre, nf_pre = pad_f(log["foff_pre"], log["fuv_pre"], log["fidx_pre"])
    fuv_post, fidx_post, nf_post = pad_f(
        log["foff_post"], log["fuv_post"], log["fidx_post"]
    )
    dim_off = log["dim_off"]
    nF = dim_off.shape[0] - 1
    maxD = int(np.diff(dim_off).max(initial=1))
    dim = np.full((nF, maxD), -1, dtype=np.int32)
    for f in range(nF):
        lo, hi = dim_off[f], dim_off[f + 1]
        dim[f, : hi - lo] = log["dim_dat"][lo:hi]
    IM = log["IM"]
    im_fwd = np.zeros(int(IM.max()) + 1, dtype=np.int32)
    im_fwd[IM] = np.arange(IM.shape[0])
    return DeviceCollapseLog(
        subset=jnp.asarray(pad_v(log["subset"], -1), dtype=jnp.int32),
        uv_pre=jnp.asarray(pad_v(log["uv_pre"], 0.0, 2), dtype=jnp.float32),
        uv_post=jnp.asarray(pad_v(log["uv_post"], 0.0, 2), dtype=jnp.float32),
        fuv_pre=jnp.asarray(fuv_pre),
        fidx_pre=jnp.asarray(fidx_pre),
        nf_pre=jnp.asarray(nf_pre),
        fuv_post=jnp.asarray(fuv_post),
        fidx_post=jnp.asarray(fidx_post),
        nf_post=jnp.asarray(nf_post),
        dim=jnp.asarray(dim),
        im_fwd=jnp.asarray(im_fwd),
        fim=jnp.asarray(log["FIM"], dtype=jnp.int32),
        im=jnp.asarray(log["IM"], dtype=jnp.int32),
        imf=jnp.asarray(log["IMF"], dtype=jnp.int32),
    )


def _query_device(dlog: DeviceCollapseLog, forward: bool, BC, BF, FIdx):
    """Batched walk: all queries advance in lockstep under one
    lax.while_loop with masked updates (no per-lane control flow — every
    table access is an explicit batched gather, which XLA lowers without
    materializing the log per query)."""
    nq = BC.shape[0]
    n_collapse = dlog.subset.shape[0]
    init_d = jnp.full((nq,), -1 if forward else n_collapse, dtype=jnp.int32)

    def next_collapse(d, f):
        row = dlog.dim[f]  # [nq, maxD]
        if forward:
            cand = jnp.where((row > d[:, None]) & (row >= 0), row, BIG)
            nxt = cand.min(axis=1)
            return jnp.where(nxt == BIG, jnp.int32(-1), nxt)
        cand = jnp.where((row < d[:, None]) & (row >= 0), row, -1)
        return cand.max(axis=1)

    def cond(state):
        return state[4]

    def body(state):
        d_prev, bc, bf, fidx, _ = state
        d = next_collapse(d_prev, fidx)        # [nq]
        act = d >= 0
        dd = jnp.where(act, d, 0)
        subset = dlog.subset[dd]               # [nq, maxV]
        uv_src = (dlog.uv_pre if forward else dlog.uv_post)[dd]   # [nq,maxV,2]
        uv_dst = (dlog.uv_post if forward else dlog.uv_pre)[dd]
        tri = (dlog.fuv_post if forward else dlog.fuv_pre)[dd]    # [nq,maxF,3]
        fid = (dlog.fidx_post if forward else dlog.fidx_pre)[dd]  # [nq,maxF]
        nf = (dlog.nf_post if forward else dlog.nf_pre)[dd]       # [nq]
        # local ids of the query corners (subset entries are unique)
        eq = subset[:, None, :] == bf[:, :, None]                 # [nq,3,maxV]
        lid = jnp.argmax(eq, axis=2)                              # [nq,3]
        q = (bc[:, :, None] * jnp.take_along_axis(
            uv_src, lid[:, :, None], axis=1
        )).sum(axis=1)                                            # [nq,2]
        # barycentric vs every destination face, masked by validity
        corner = lambda k: jnp.take_along_axis(
            uv_dst, tri[:, :, k][:, :, None], axis=1
        )
        a, b2, c2 = corner(0), corner(1), corner(2)               # [nq,maxF,2]
        v0 = b2 - a
        v1 = c2 - a
        v2 = q[:, None, :] - a
        d00 = (v0 * v0).sum(-1)
        d01 = (v0 * v1).sum(-1)
        d11 = (v1 * v1).sum(-1)
        d20 = (v2 * v0).sum(-1)
        d21 = (v2 * v1).sum(-1)
        den = d00 * d11 - d01 * d01
        v = (d11 * d20 - d01 * d21) / den
        w = (d00 * d21 - d01 * d20) / den
        u = 1.0 - v - w
        B = jnp.stack([u, v, w], axis=2)                          # [nq,maxF,3]
        mind = -B.min(axis=2)
        valid = jnp.arange(mind.shape[1])[None, :] < nf[:, None]
        mind = jnp.where(valid, mind, jnp.inf)
        best = jnp.argmin(mind, axis=1)                           # [nq]
        Bb = jnp.take_along_axis(B, best[:, None, None], axis=1)[:, 0, :]
        Bb = jnp.maximum(Bb, 0.0)
        Bb = Bb / Bb.sum(axis=1, keepdims=True)
        tri_best = jnp.take_along_axis(tri, best[:, None, None], axis=1)[:, 0, :]
        bf_new = jnp.take_along_axis(subset, tri_best, axis=1)
        fidx_new = jnp.take_along_axis(fid, best[:, None], axis=1)[:, 0]
        # masked commit; mirrors the host walk (ssp.cpp walk_step, reference
        # query_fine_to_coarse.cpp:90-123) which starts bestmind=1.0 and only
        # relocates when some face achieves mind < 1.0 — on a degenerate
        # patch with no such face the point is left unchanged (the walk
        # still advances to the next collapse).
        mind_best = jnp.take_along_axis(mind, best[:, None], axis=1)[:, 0]
        commit = act & (mind_best < 1.0)
        bc = jnp.where(commit[:, None], Bb, bc)
        bf = jnp.where(commit[:, None], bf_new, bf)
        fidx = jnp.where(commit, fidx_new, fidx)
        d_next = jnp.where(act, d, d_prev)
        return (d_next, bc, bf, fidx, act.any())

    st = (init_d, BC, BF, FIdx, jnp.bool_(True))
    st = jax.lax.while_loop(cond, body, st)
    return st[1], st[2], st[3]


def _query_chunked(dlog, forward, BC, BF, FIdx, chunk):
    """lax.map over fixed-size chunks: each chunk's while_loop retires as
    soon as ITS longest walker finishes, so total work tracks the per-chunk
    maximum walk length instead of the global maximum.

    Per-chunk compaction: walkers are first sorted by a walk-start proxy
    (the first/last collapse record touching the seed face), which groups
    zero- and short-walk queries into chunks that retire immediately —
    without the sort one long walker per chunk pins EVERY chunk to the
    global maximum.  Static shapes throughout (one dispatch); the sort is
    O(n log n) on device and is undone after the map."""
    nq = BC.shape[0]
    pad = (-nq) % chunk
    BCp = jnp.pad(BC, ((0, pad), (0, 0)))
    BFp = jnp.pad(BF, ((0, pad), (0, 0)))
    FIp = jnp.pad(FIdx, (0, pad))
    row = dlog.dim[FIp]  # [n, maxD] collapse records touching the seed face
    if forward:
        # forward walks visit records in increasing id from the seed's
        # first touch; never-touched faces (all -1 -> BIG) walk 0 steps
        start = jnp.where(row >= 0, row, BIG).min(axis=1)
        order = jnp.argsort(-start)  # BIG (no work) first, early-touch last
    else:
        # backward walks descend from the largest record below n_collapse;
        # untouched faces (max -1) walk 0 steps
        start = row.max(axis=1)
        order = jnp.argsort(start)
    # padded tail sorts wherever its seed face (id 0) lands — harmless
    inv = jnp.argsort(order)
    BCp, BFp, FIp = BCp[order], BFp[order], FIp[order]
    C = BCp.shape[0] // chunk
    out = jax.lax.map(
        lambda t: _query_device(dlog, forward, *t),
        (
            BCp.reshape(C, chunk, 3),
            BFp.reshape(C, chunk, 3),
            FIp.reshape(C, chunk),
        ),
    )
    return (
        out[0].reshape(-1, 3)[inv][:nq],
        out[1].reshape(-1, 3)[inv][:nq],
        out[2].reshape(-1)[inv][:nq],
    )


_query_fwd = jax.jit(
    lambda dlog, BC, BF, FIdx: _query_chunked(dlog, True, BC, BF, FIdx, 4096)
)
_query_bwd = jax.jit(
    lambda dlog, BC, BF, FIdx: _query_chunked(dlog, False, BC, BF, FIdx, 4096)
)


def query_fine_to_coarse_device(dlog: DeviceCollapseLog, BC, BF, FIdx):
    """Device query: fine -> coarse; same contract as query/maps.py."""
    BC = jnp.asarray(BC, dtype=jnp.float32)
    BF = jnp.asarray(BF, dtype=jnp.int32)
    FIdx = jnp.asarray(FIdx, dtype=jnp.int32)
    BC, BF, FIdx = _query_fwd(dlog, BC, BF, FIdx)
    return (
        np.asarray(BC, dtype=np.float64),
        np.asarray(dlog.im_fwd[BF], dtype=np.int64),
        np.asarray(dlog.fim[FIdx], dtype=np.int64),
    )


def query_coarse_to_fine_device(dlog: DeviceCollapseLog, BC, BF, FIdx):
    """Device query: coarse -> fine; same contract as query/maps.py."""
    BC = jnp.asarray(BC, dtype=jnp.float32)
    BF = jnp.asarray(dlog.im[jnp.asarray(BF, dtype=jnp.int32)], dtype=jnp.int32)
    FIdx = jnp.asarray(dlog.imf[jnp.asarray(FIdx, dtype=jnp.int32)], dtype=jnp.int32)
    BC, BF, FIdx = _query_bwd(dlog, BC, BF, FIdx)
    return (
        np.asarray(BC, dtype=np.float64),
        np.asarray(BF, dtype=np.int64),
        np.asarray(FIdx, dtype=np.int64),
    )
