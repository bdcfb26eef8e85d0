"""CSR / BSR sparse operators as JAX pytrees.

Replaces the reference's PETSc `Mat` usage (MatCreateAIJ + MatSetValues
assembly + MatMult, e.g. /root/reference/tests/WaveSystem_SphericalExplosion_
expl_seq.cxx:38,83-90 and src/WaveSystem.cxx:78-90).

Design notes:
- Assembly happens on host (NumPy) once — it is O(nnz) preprocessing — and
  produces static-shape device arrays. Duplicate COO entries are summed
  (ADD_VALUES semantics).
- The default SpMV is gather + segment_sum over a fixed-nnz layout. A padded
  ELL ("sliced-ELL") layout is also provided: for FV meshes the row degree
  is tightly bounded (faces-per-cell), so ELL padding is small and the SpMV
  becomes dense vector math — `y[r] = Σ_k vals[r,k] * x[cols[r,k]]`.
- BSR (block CSR, block = dim+1 for the wave system) stores dense blocks and
  contracts them with einsum as batched small matmuls.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


def coo_to_csr_arrays(n_rows: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """Sum-duplicate COO → sorted CSR arrays (host-side, NumPy)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    # lexsort by (row, col), then reduce duplicates
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        key = rows * (cols.max() + 1 if len(cols) else 1) + cols
        uniq_mask = np.empty(len(key), dtype=bool)
        uniq_mask[0] = True
        np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
        idx = np.cumsum(uniq_mask) - 1
        out_vals = np.zeros(int(idx[-1]) + 1, dtype=vals.dtype)
        np.add.at(out_vals, idx, vals)
        rows, cols, vals = rows[uniq_mask], cols[uniq_mask], out_vals
    indptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)
    return indptr, cols.astype(np.int32), vals


@jax.tree_util.register_pytree_node_class
@dataclass
class CSRMatrix:
    """Compressed-sparse-row matrix; all arrays device-resident, static shapes."""

    indptr: jax.Array  # (n_rows+1,) int32
    indices: jax.Array  # (nnz,) int32
    data: jax.Array  # (nnz,)
    shape: tuple[int, int]
    # row index per nnz, precomputed so SpMV is a pure segment_sum (no
    # searchsorted in the hot loop)
    row_ids: jax.Array  # (nnz,) int32

    def tree_flatten(self):
        return (self.indptr, self.indices, self.data, self.row_ids), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        indptr, indices, data, row_ids = children
        (shape,) = aux
        return cls(indptr, indices, data, shape, row_ids)

    @classmethod
    def from_coo(cls, n_rows: int, n_cols: int, rows, cols, vals, dtype=jnp.float32):
        indptr, indices, data = coo_to_csr_arrays(n_rows, rows, cols, vals)
        row_ids = np.repeat(np.arange(n_rows, dtype=np.int32), np.diff(indptr))
        return cls(
            jnp.asarray(indptr),
            jnp.asarray(indices),
            jnp.asarray(data, dtype=dtype),
            (n_rows, n_cols),
            jnp.asarray(row_ids),
        )

    @classmethod
    def from_scipy(cls, A, dtype=jnp.float32):
        A = A.tocsr()
        row_ids = np.repeat(np.arange(A.shape[0], dtype=np.int32), np.diff(A.indptr))
        return cls(
            jnp.asarray(A.indptr.astype(np.int32)),
            jnp.asarray(A.indices.astype(np.int32)),
            jnp.asarray(A.data, dtype=dtype),
            tuple(A.shape),
            jnp.asarray(row_ids),
        )

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @jax.jit
    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A x via gather + segment_sum (one fused XLA scatter-add).
        x may be (n,) or (n, k) — columns are transformed independently."""
        gathered = x[self.indices]
        contrib = (self.data[:, None] * gathered) if x.ndim == 2 else self.data * gathered
        return jax.ops.segment_sum(contrib, self.row_ids, num_segments=self.shape[0])

    def __matmul__(self, x):
        return self.matvec(x)

    def matvec_partial(self) -> jax.tree_util.Partial:
        """Pytree-callable y=Ax: pass to make_gmres so the matrix arrays are
        runtime parameters of ONE cached executable (not HLO constants)."""
        return jax.tree_util.Partial(CSRMatrix.matvec, self)

    @jax.jit
    def diagonal(self) -> jax.Array:
        """Extract diag(A) (for Jacobi PCs); rows lacking a stored diagonal get 0."""
        n = self.shape[0]
        is_diag = self.row_ids == self.indices
        return jax.ops.segment_sum(
            jnp.where(is_diag, self.data, 0.0), self.row_ids, num_segments=n
        )

    def to_ell(self) -> "ELLMatrix":
        """Convert to padded-ELL layout (host side)."""
        indptr = np.asarray(self.indptr)
        indices = np.asarray(self.indices)
        data = np.asarray(self.data)
        n = self.shape[0]
        deg = np.diff(indptr)
        k = int(deg.max()) if n else 0
        cols = np.zeros((n, k), dtype=np.int32)
        vals = np.zeros((n, k), dtype=data.dtype)
        for r in range(n):
            s, e = indptr[r], indptr[r + 1]
            cols[r, : e - s] = indices[s:e]
            vals[r, : e - s] = data[s:e]
        return ELLMatrix(jnp.asarray(cols), jnp.asarray(vals), self.shape)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (np.asarray(self.data), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()


@jax.tree_util.register_pytree_node_class
@dataclass
class ELLMatrix:
    """Padded ELLPACK layout: regular (n_rows, max_deg) gather — the
    regular-shape SpMV for bounded-degree FV operators."""

    cols: jax.Array  # (n_rows, k) int32, padded with 0
    vals: jax.Array  # (n_rows, k), padded with 0.0
    shape: tuple[int, int]

    def tree_flatten(self):
        return (self.cols, self.vals), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, vals = children
        (shape,) = aux
        return cls(cols, vals, shape)

    @jax.jit
    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.sum(self.vals * x[self.cols], axis=1)

    def __matmul__(self, x):
        return self.matvec(x)


@jax.tree_util.register_pytree_node_class
@dataclass
class BSRMatrix:
    """Block-CSR with dense (b×b) blocks — the wave system's (dim+1)-blocks.

    Unknown layout is cell-major interleaved (cell j owns rows j·b..j·b+b-1),
    matching the reference (WaveSystem.cxx addValue, :78-90).
    """

    indptr: jax.Array  # (n_brows+1,) int32 — block rows
    indices: jax.Array  # (nblocks,) int32 — block cols
    blocks: jax.Array  # (nblocks, b, b)
    shape: tuple[int, int]  # scalar shape (n_brows*b, n_bcols*b)
    brow_ids: jax.Array  # (nblocks,) int32

    def tree_flatten(self):
        return (self.indptr, self.indices, self.blocks, self.brow_ids), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        indptr, indices, blocks, brow_ids = children
        (shape,) = aux
        return cls(indptr, indices, blocks, shape, brow_ids)

    @classmethod
    def from_block_coo(cls, n_brows: int, n_bcols: int, brows, bcols, blocks, dtype=jnp.float32):
        """Duplicate (brow,bcol) blocks are summed (ADD_VALUES semantics)."""
        brows = np.asarray(brows, dtype=np.int64)
        bcols = np.asarray(bcols, dtype=np.int64)
        blocks = np.asarray(blocks)
        b = blocks.shape[-1]
        order = np.lexsort((bcols, brows))
        brows, bcols, blocks = brows[order], bcols[order], blocks[order]
        if len(brows):
            key = brows * n_bcols + bcols
            uniq = np.empty(len(key), dtype=bool)
            uniq[0] = True
            np.not_equal(key[1:], key[:-1], out=uniq[1:])
            idx = np.cumsum(uniq) - 1
            out = np.zeros((int(idx[-1]) + 1, b, b), dtype=blocks.dtype)
            np.add.at(out, idx, blocks)
            brows, bcols, blocks = brows[uniq], bcols[uniq], out
        indptr = np.zeros(n_brows + 1, dtype=np.int32)
        np.add.at(indptr, brows + 1, 1)
        indptr = np.cumsum(indptr, dtype=np.int32)
        brow_ids = np.repeat(np.arange(n_brows, dtype=np.int32), np.diff(indptr))
        return cls(
            jnp.asarray(indptr),
            jnp.asarray(bcols.astype(np.int32)),
            jnp.asarray(blocks, dtype=dtype),
            (n_brows * b, n_bcols * b),
            jnp.asarray(brow_ids),
        )

    @property
    def block_size(self) -> int:
        return int(self.blocks.shape[-1])

    @property
    def n_brows(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @jax.jit
    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A x, x flat cell-major (n_bcols*b,)."""
        b = self.block_size
        xb = x.reshape(-1, b)
        gathered = xb[self.indices]  # (nblocks, b)
        contrib = jnp.einsum("nij,nj->ni", self.blocks, gathered, precision=jax.lax.Precision.HIGHEST)
        yb = jax.ops.segment_sum(contrib, self.brow_ids, num_segments=self.n_brows)
        return yb.reshape(-1)

    def __matmul__(self, x):
        return self.matvec(x)

    def matvec_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(BSRMatrix.matvec, self)

    @jax.jit
    def block_diagonal(self) -> jax.Array:
        """(n_brows, b, b) diagonal blocks (for point-block Jacobi)."""
        is_diag = self.brow_ids == self.indices
        sel = jnp.where(is_diag[:, None, None], self.blocks, 0.0)
        return jax.ops.segment_sum(sel, self.brow_ids, num_segments=self.n_brows)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.bsr_matrix(
            (np.asarray(self.blocks), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        ).tocsr()

    def to_csr(self, dtype=None) -> CSRMatrix:
        return CSRMatrix.from_scipy(self.to_scipy(), dtype=dtype or self.blocks.dtype)

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()
