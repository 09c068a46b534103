"""Device-side Galerkin coarsening with cached symbolic structure.

The reference recomputes A_{l+1} = P^T A_l P with Eigen SpGEMM inside the
application hot loops — every MCF time step (05_example_mean_curvature_flow/
main.cpp:74) and every balloon Newton iteration
(implicit_euler_mg_balloon.h:75).  The hierarchy P is FIXED, so the
sparsity of every Galerkin product is static; only values change.

We therefore precompute, per level, the symbolic expansion
    A_out[k] = sum_{(a,b,c) in triples(k)} P[a] * A_in[b] * P[c]
and fold the static P*P weight products into a single coefficient array,
reducing each per-solve coarsening to

    vals_out = segment_sum(w * A_in_vals[idx], seg)        (one fused pass)

followed by a static scatter into the level's ELL layout.  The whole
multi-level refresh jits into one device program — XLA fuses the gathers,
multiplies and segment-sums; no host SpGEMM in the hot loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class LevelPlan:
    """Symbolic PtAP for one level (static per hierarchy).

    The triple product is stored GATHER-ONLY: short segments (the vast
    majority) are padded into an ELL layout [nnz_out, W] contracted with
    one gather+multiply+reduce, and the long-segment tail (if any) goes
    through a sorted segment_sum, so the refresh needs no scatter-adds.

    Registered as a pytree so plans can be passed as jit ARGUMENTS —
    closure-capturing these (multi-million-entry) arrays would embed them
    as compile-time constants in every compiled program."""

    # ELL-ized short segments: indices into the A_in value vector PADDED by
    # one trailing zero (index n_in = padding), with folded P*P weights
    gat_idx: jnp.ndarray   # [nnz_out, W] int32
    gat_w: jnp.ndarray     # [nnz_out, W]
    # long-segment tail (may be empty)
    tail_idx: jnp.ndarray  # [n_tail] into A_in values
    tail_w: jnp.ndarray    # [n_tail]
    tail_seg: jnp.ndarray  # [n_tail] output nnz id (ascending)
    nnz_in: int
    nnz_out: int
    # ELL layout of the output level: gather map from value vector
    # (padded by one trailing zero) into [n, width]
    ell_gather: jnp.ndarray   # [n, width] int32 (nnz_out = padding)
    ell_shape: tuple[int, int]
    ell_indices: jnp.ndarray  # static int32 [n, width] column ids
    diag_idx: jnp.ndarray     # [n] nnz id of each diagonal entry

    def tree_flatten(self):
        children = (
            self.gat_idx, self.gat_w, self.tail_idx, self.tail_w,
            self.tail_seg, self.ell_gather, self.ell_indices, self.diag_idx,
        )
        return children, (self.nnz_in, self.nnz_out, self.ell_shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (gat_idx, gat_w, tail_idx, tail_w, tail_seg, ell_gather,
         ell_indices, diag_idx) = children
        return cls(
            gat_idx=gat_idx, gat_w=gat_w, tail_idx=tail_idx, tail_w=tail_w,
            tail_seg=tail_seg, nnz_in=aux[0], nnz_out=aux[1],
            ell_gather=ell_gather, ell_shape=aux[2], ell_indices=ell_indices,
            diag_idx=diag_idx,
        )


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class GalerkinPlan:
    levels: tuple[LevelPlan, ...]
    # finest-level ELL layout (same fields for level 0)
    lvl0: LevelPlan

    def tree_flatten(self):
        return (self.levels, self.lvl0), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(levels=children[0], lvl0=children[1])


def _ell_layout(A: sp.csr_matrix, min_width: int = 1):
    """Static ELL layout of a CSR pattern: a GATHER map from the nnz value
    vector (padded by one trailing zero at index nnz) into [n, width],
    plus padded column ids (padding points at row 0 with weight 0 —
    ops/sparse.py) and diagonal nnz ids."""
    n, _ = A.shape
    counts = np.diff(A.indptr)
    width = max(int(counts.max(initial=0)), min_width)
    rows = np.repeat(np.arange(n), counts)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    indices = np.zeros((n, width), dtype=np.int32)
    indices[rows, slots] = A.indices
    gather = np.full((n, width), A.nnz, dtype=np.int32)
    gather[rows, slots] = np.arange(A.nnz, dtype=np.int32)
    # diagonal nnz ids (vectorized: canonical CSR keys are globally sorted)
    pkeys = rows.astype(np.int64) * A.shape[1] + A.indices
    dkeys = np.arange(n, dtype=np.int64) * (A.shape[1] + 1)
    pos = np.searchsorted(pkeys, dkeys)
    ok = (pos < pkeys.size) & (pkeys[np.minimum(pos, pkeys.size - 1)] == dkeys)
    assert ok.all(), "missing diagonal"
    diag_idx = pos.astype(np.int64)
    return gather, (n, width), indices, diag_idx


def _ellize_segments(seg, idx, w, nnz_in, nnz_out, W_cap=32):
    """Split sorted segments into an ELL part (first <= W entries of each
    segment) and a tail for segment_sum.  Padding gathers the trailing zero
    at index nnz_in with weight 0."""
    counts = np.bincount(seg, minlength=nnz_out)
    W = int(min(max(counts.max(initial=1), 1), W_cap))
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos_in_seg = np.arange(seg.shape[0]) - starts[seg]
    in_ell = pos_in_seg < W
    gat_idx = np.full((nnz_out, W), nnz_in, dtype=np.int32)
    gat_w = np.zeros((nnz_out, W))
    gat_idx[seg[in_ell], pos_in_seg[in_ell]] = idx[in_ell]
    gat_w[seg[in_ell], pos_in_seg[in_ell]] = w[in_ell]
    tail = ~in_ell
    return (
        gat_idx, gat_w,
        idx[tail].astype(np.int64), w[tail], seg[tail].astype(np.int64),
    )


def galerkin_triples(A: sp.csr_matrix, P: sp.csr_matrix):
    """Expand PT @ A @ P into sorted contribution triples.

    Returns (seg, in_id, w, A_out): for each contribution, the OUTPUT nnz
    segment id (ascending), the INPUT A-nnz id it reads, and the scalar
    weight Pdat[a]*Pdat[c]; A_out is the coarse CSR pattern (zeros) whose
    canonical nnz order defines the segment ids.  This is the raw form
    the gather plan (_level_symbolic) is built from."""
    A = A.tocsr()
    A.sum_duplicates()
    P = P.tocsr()
    P.sum_duplicates()
    nnzA = A.nnz
    # For A nnz (i, j, b): rows of the products are P columns of row i,
    # cols are P columns of row j.
    Ai = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    Aj = A.indices
    # expand over P rows i and j (each <= 3 nnz)
    Pptr, Pind = P.indptr, P.indices
    Pcnt = np.diff(Pptr)
    ci = Pcnt[Ai]  # count of left factors per A nnz
    cj = Pcnt[Aj]
    reps = ci * cj
    b = np.repeat(np.arange(nnzA), reps)  # A nnz id per triple
    # left/right P nnz offsets per triple via meshgrid within each A nnz
    total = int(reps.sum())
    # build local (u, v) grids: u in [0, ci), v in [0, cj)
    offs = np.concatenate([[0], np.cumsum(reps)])
    local = np.arange(total) - np.repeat(offs[:-1], reps)
    u = local // np.repeat(cj, reps)
    v = local % np.repeat(cj, reps)
    a = np.repeat(Pptr[Ai], reps) + u  # left P nnz id
    c = np.repeat(Pptr[Aj], reps) + v  # right P nnz id
    out_r = Pind[a]
    out_c = Pind[c]
    # sort by (out_r, out_c) to form segments
    nc = int(P.shape[1])
    key = out_r.astype(np.int64) * nc + out_c
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, seg = np.unique(key_s, return_inverse=True)
    nnz_out = uniq.shape[0]
    # output CSR pattern
    out_rows = (uniq // nc).astype(np.int64)
    out_cols = (uniq % nc).astype(np.int64)
    counts = np.bincount(out_rows, minlength=nc)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    A_out = sp.csr_matrix(
        (np.zeros(nnz_out), out_cols, indptr), shape=(nc, nc)
    )
    Pdat = P.data
    w = Pdat[a[order]] * Pdat[c[order]]
    return seg, b[order], w, A_out


def _level_symbolic(A: sp.csr_matrix, P: sp.csr_matrix) -> LevelPlan:
    """Expand PT @ A @ P into (triple index, weight, output segment)."""
    seg, in_id, w, A_out = galerkin_triples(A, P)
    nnzA = A.tocsr().nnz
    nnz_out = A_out.nnz
    gather, shape, indices, diag_idx = _ell_layout(A_out)
    gat_idx, gat_w, tail_idx, tail_w, tail_seg = _ellize_segments(
        seg, in_id, w, nnzA, nnz_out
    )
    return LevelPlan(
        gat_idx=jnp.asarray(gat_idx),
        gat_w=jnp.asarray(gat_w),
        tail_idx=jnp.asarray(tail_idx),
        tail_w=jnp.asarray(tail_w),
        tail_seg=jnp.asarray(tail_seg),
        nnz_in=nnzA,
        nnz_out=nnz_out,
        ell_gather=jnp.asarray(gather),
        ell_shape=shape,
        ell_indices=jnp.asarray(indices),
        diag_idx=jnp.asarray(diag_idx),
    )


def build_galerkin_plan(A0_pattern: sp.csr_matrix, Ps: list[sp.spmatrix]) -> GalerkinPlan:
    """Host symbolic setup: A0's ELL layout + per-level PtAP expansions.

    A0_pattern: finest-level matrix (pattern + any values); Ps[l] maps
    level l+1 -> level l as in mg_data.
    """
    A = A0_pattern.tocsr().copy()
    A.sum_duplicates()
    gather, shape, indices, diag_idx = _ell_layout(A)
    # dtype=int canonicalizes to int32/int64 per the x64 flag without the
    # "truncated to int32" warning an explicit int64 request emits
    empty_i = jnp.zeros(0, dtype=int)
    lvl0 = LevelPlan(
        gat_idx=jnp.zeros((0, 1), dtype=jnp.int32),
        gat_w=jnp.zeros((0, 1)),
        tail_idx=empty_i,
        tail_w=jnp.zeros(0),
        tail_seg=empty_i,
        nnz_in=A.nnz,
        nnz_out=A.nnz,
        ell_gather=jnp.asarray(gather),
        ell_shape=shape,
        ell_indices=jnp.asarray(indices),
        diag_idx=jnp.asarray(diag_idx),
    )
    levels = []
    A_sym = A
    for P in Ps:
        plan = _level_symbolic(A_sym, P.tocsr())
        levels.append(plan)
        A_sym = plan_pattern(plan)
    return GalerkinPlan(levels=tuple(levels), lvl0=lvl0)


def plan_pattern(plan: LevelPlan) -> sp.csr_matrix:
    """Reconstruct a level's CSR pattern from its ELL gather layout
    (real slots are those gathering below nnz_out)."""
    n, w = plan.ell_shape
    gather = np.asarray(plan.ell_gather)
    cols = np.asarray(plan.ell_indices)
    valid = gather < plan.nnz_out
    rows = np.repeat(np.arange(n), w).reshape(n, w)
    return sp.coo_matrix(
        (np.ones(int(valid.sum())), (rows[valid], cols[valid])),
        shape=(n, n),
    ).tocsr()


def galerkin_chain(A0: sp.spmatrix, Ps: list[sp.spmatrix]) -> list[sp.csr_matrix]:
    """Galerkin-coarsen keeping the full SYMBOLIC Pᵀ A P pattern per level
    (explicit zeros retained), so every level's stored CSR layout matches
    build_galerkin_plan's canonical order.

    scipy's numeric triple product can drop entries whose products cancel
    exactly — e.g. through the exact-zero barycentric weights SSP
    prolongations carry (reference src/get_prolong.cpp:23-39 seeds corner
    coords [1,0,0]) — which de-synchronizes a numerically-built chain from
    the symbolic plan.  Consumers that later refresh values on the fixed
    pattern (HaloHierarchy.enable_refresh) must build their hierarchy from
    THIS chain.
    """
    A0 = A0.tocsr().copy()
    A0.sum_duplicates()
    plan = build_galerkin_plan(A0, Ps)
    vals = refresh_values(plan, jnp.asarray(A0.data), raw=True)
    As = [A0]
    for lv, pl_ in enumerate(plan.levels):
        pat = plan_pattern(pl_)
        As.append(
            sp.csr_matrix(
                (
                    np.asarray(vals[lv + 1], dtype=np.float64),
                    pat.indices.copy(),
                    pat.indptr.copy(),
                ),
                shape=pat.shape,
            )
        )
    return As


def refresh_values(plan: GalerkinPlan, A0_vals: jnp.ndarray, dtype=None,
                   raw: bool = False):
    """All-level Galerkin value refresh on device.

    A0_vals: finest-level CSR nnz values (pattern = the one given to
    build_galerkin_plan).  Returns per-level (ell_data [n,width], diag [n]),
    finest first — or, with raw=True, the per-level nnz value VECTORS in
    canonical CSR order (for consumers with their own layouts, e.g. the
    sharded halo solver).  Jit-friendly: shapes static, one
    gather+segment_sum per level.
    """
    dtype = dtype or A0_vals.dtype
    vals = A0_vals.astype(dtype)
    out = []

    def to_ell(pl_, v):
        if raw:
            return v
        # gather-only ELL fill (padding slot reads the appended zero)
        vpad = jnp.concatenate([v, jnp.zeros(1, dtype=dtype)])
        return vpad[pl_.ell_gather], v[pl_.diag_idx]

    out.append(to_ell(plan.lvl0, vals))
    for pl_ in plan.levels:
        vpad = jnp.concatenate([vals, jnp.zeros(1, dtype=dtype)])
        vals = (pl_.gat_w.astype(dtype) * vpad[pl_.gat_idx]).sum(axis=1)
        if pl_.tail_idx.shape[0]:
            # long-segment tail (ascending ids)
            vals = vals + jax.ops.segment_sum(
                pl_.tail_w.astype(dtype) * vpad[pl_.tail_idx],
                pl_.tail_seg,
                num_segments=pl_.nnz_out,
                indices_are_sorted=True,
            )
        out.append(to_ell(pl_, vals))
    return out
