"""Device sparse-matrix containers (ELL / padded-row format) and SpMV.

Design: the reference keeps Eigen CSC matrices and does sequential sweeps
(src/mg_VCycle.cpp:146-177). On the device the layout is a fixed-width
padded row format (ELL): cotan Laplacians have ~7 nnz/row and prolongation
operators <= 3 nnz/row, so padding waste is tiny and every row becomes a
constant-shape gather + reduce, which XLA fuses into one pass over the
values, indices and gathered vector entries. Padding entries point at row
0 with weight 0.

Multi-column products run at Precision.HIGHEST: an f32 einsum may
otherwise run in TF32 on the GPU (~3 decimal digits), which would stall
the solver's residual stop tests.

ELLMatrix is a JAX pytree: (indices, data) dynamic, shape static.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

@jax.tree_util.register_pytree_node_class
@dataclass
class ELLMatrix:
    """Padded-row sparse matrix on device.

    indices: int32 [n_rows, width] column ids (0 for padding)
    data:    float  [n_rows, width] values (0 for padding)
    n_cols:  static int
    """

    indices: jnp.ndarray
    data: jnp.ndarray
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def width(self) -> int:
        return self.indices.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    def tree_flatten(self):
        return (self.indices, self.data), (self.n_cols,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        indices, data = children
        return cls(indices=indices, data=data, n_cols=aux[0])


def ell_from_csr(
    A: sp.spmatrix, dtype=jnp.float64, min_width: int = 1
) -> ELLMatrix:
    """Convert a scipy sparse matrix to device ELL (host-side)."""
    A = A.tocsr()
    A.sum_duplicates()
    n, m = A.shape
    counts = np.diff(A.indptr)
    width = max(int(counts.max(initial=0)), min_width)
    indices = np.zeros((n, width), dtype=np.int32)
    data = np.zeros((n, width), dtype=np.float64)
    if A.nnz:
        rows = np.repeat(np.arange(n), counts)
        offsets = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
        indices[rows, offsets] = A.indices
        data[rows, offsets] = A.data
    return ELLMatrix(
        indices=jnp.asarray(indices),
        data=jnp.asarray(data, dtype=dtype),
        n_cols=m,
    )


def ell_to_csr(E: ELLMatrix) -> sp.csr_matrix:
    """Round-trip back to scipy (testing / host Galerkin)."""
    idx = np.asarray(E.indices)
    dat = np.asarray(E.data)
    n, w = idx.shape
    rows = np.repeat(np.arange(n), w)
    A = sp.coo_matrix(
        (dat.ravel(), (rows, idx.ravel())), shape=(n, E.n_cols)
    ).tocsr()
    A.sum_duplicates()
    A.eliminate_zeros()
    return A


def ell_spmv(A: ELLMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x for x of shape [n_cols] or [n_cols, nrhs].

    One gather + one reduce per row; XLA fuses this into a single
    bandwidth-bound pass.
    """
    gathered = x[A.indices]  # [n, w] or [n, w, nrhs]
    if x.ndim == 1:
        return (A.data * gathered).sum(axis=1)
    return jnp.einsum("nw,nwr->nr", A.data, gathered, precision=HIGHEST)


def ell_spmv_rows(
    A: ELLMatrix, rows: jnp.ndarray, x: jnp.ndarray
) -> jnp.ndarray:
    """(A @ x)[rows] without touching other rows (used by colored smoothing)."""
    idx = A.indices[rows]
    dat = A.data[rows]
    gathered = x[idx]
    if x.ndim == 1:
        return (dat * gathered).sum(axis=1)
    return jnp.einsum("nw,nwr->nr", dat, gathered, precision=HIGHEST)
