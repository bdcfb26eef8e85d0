"""Row-partitioned distributed SpMV over a device mesh.

Replacement for PETSc's MPI row-block Mat/Vec layout (MatCreateAIJ
with PETSC_DECIDE + internal VecScatter halo exchange, used in every mpi
driver, e.g. WaveSystem_..._impl_mpi.cxx:63-85).

Layout: rows are split into P contiguous blocks (padded to equal size); each
device holds its block in padded-ELL form (rows_per_shard, k). The source
vector is sharded the same way; inside shard_map each device all_gathers the
full vector (the FV operators here have bounded bandwidth, but a general
gather keeps round 1 simple and correct — the halo-minimal ppermute exchange
is an optimization tracked for the structured partitioning) and produces its
row block locally. Krylov reductions over such sharded vectors lower to
psum collectives automatically under jit.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from circulantpreconditioner_tpu.ops.csr import CSRMatrix


def _spmv_partial(A) -> jax.tree_util.Partial:
    """The operator as a Partial pytree: cols/vals enter jitted consumers
    as runtime PARAMETERS. Required on multi-process meshes (global arrays
    may not be closed over, only passed as arguments) and avoids
    HLO-constant recompiles per matrix."""
    return jax.tree_util.Partial(A._spmv, A.cols, A.vals)


class ShardedELLMatrix:
    """Row-sharded padded-ELL operator: y = A x with x, y sharded vectors."""

    def __init__(self, A: CSRMatrix, mesh: Mesh, axis: str = "shard",
                 row_multiple: int = 1):
        self.mesh = mesh
        self.axis = axis
        n, m = A.shape
        Pn = mesh.shape[axis]
        self.n = n
        # pad so each shard's row count is a multiple of row_multiple (lets
        # per-shard block preconditioners reshape (-1, b) without resharding)
        q = Pn * max(int(row_multiple), 1)
        self.n_padded = ((n + q - 1) // q) * q
        ell = A.to_ell()
        cols = np.asarray(ell.cols)
        vals = np.asarray(ell.vals)
        pad = self.n_padded - n
        if pad:
            cols = np.concatenate([cols, np.zeros((pad, cols.shape[1]), cols.dtype)])
            vals = np.concatenate([vals, np.zeros((pad, vals.shape[1]), vals.dtype)])
        row_sharding = NamedSharding(mesh, P(axis, None))
        self.cols = jax.device_put(cols, row_sharding)
        self.vals = jax.device_put(vals, row_sharding)
        self.vec_sharding = NamedSharding(mesh, P(axis))
        axis_name = axis

        def local_spmv(cols_loc, vals_loc, x_loc):
            x_full = jax.lax.all_gather(x_loc, axis_name, tiled=True)
            return jnp.sum(vals_loc * x_full[cols_loc], axis=1)

        self._spmv = jax.jit(
            jax.shard_map(
                local_spmv,
                mesh=mesh,
                in_specs=(P(axis, None), P(axis, None), P(axis)),
                out_specs=P(axis),
            )
        )

    def shard_vector(self, x) -> jax.Array:
        """Pad a global length-n vector to n_padded and shard it."""
        x = np.asarray(x)
        if x.shape[0] != self.n_padded:
            x = np.concatenate([x, np.zeros(self.n_padded - x.shape[0], x.dtype)])
        return jax.device_put(x, self.vec_sharding)

    def unshard_vector(self, x: jax.Array) -> np.ndarray:
        return np.asarray(x)[: self.n]

    def matvec(self, x: jax.Array) -> jax.Array:
        """x: sharded padded vector → sharded padded result. Padded tail rows
        are all-zero in ELL, so they stay zero and never pollute dots."""
        return self._spmv(self.cols, self.vals, x)

    def matvec_partial(self) -> jax.tree_util.Partial:
        """See _spmv_partial."""
        return _spmv_partial(self)

    def __matmul__(self, x):
        return self.matvec(x)


class HaloELLMatrix:
    """Row-sharded SpMV with nearest-neighbour HALO exchange via ppermute.

    The PETSc analog: VecScatter ghost updates inside MatMult
    (SURVEY.md §2.6 'halo vector entries exchanged via ppermute over ICI').
    Requires the matrix bandwidth w = max|col−row| to fit within one
    row-block (true for lexicographically ordered FV meshes sharded into
    slabs: w ≈ nx·ny ≤ N/P). Each device then needs only the trailing w
    entries of its left neighbour and the leading w of its right neighbour —
    two ppermute messages of size w instead of an all_gather of size N.
    Column indices are pre-localised to the extended window on host.
    """

    def __init__(self, A: CSRMatrix, mesh: Mesh, axis: str = "shard",
                 row_multiple: int = 1):
        self.mesh = mesh
        self.axis = axis
        n, _ = A.shape
        Pn = mesh.shape[axis]
        self.n = n
        rm = max(int(row_multiple), 1)
        B = ((n + Pn * rm - 1) // (Pn * rm)) * rm
        ell = A.to_ell()
        cols0 = np.asarray(ell.cols)
        vals0 = np.asarray(ell.vals)
        active0 = vals0 != 0.0
        band = np.abs(cols0 - np.arange(n)[:, None])[active0]
        w = int(band.max()) if band.size else 0
        if w > B:
            # grow the row-block (extra zero padding) so one-neighbour halo
            # exchange still works for slightly-super-block bandwidths
            B_fit = ((w + rm - 1) // rm) * rm
            if B_fit > 2 * B:
                raise ValueError(
                    f"bandwidth {w} exceeds 2x row-block {B}; use ShardedELLMatrix")
            B = B_fit
        self.n_padded = B * Pn
        self.block = B
        cols = cols0
        vals = vals0
        pad = self.n_padded - n
        if pad:
            cols = np.concatenate([cols, np.zeros((pad, cols.shape[1]), cols.dtype)])
            vals = np.concatenate([vals, np.zeros((pad, vals.shape[1]), vals.dtype)])
        rows_global = np.arange(self.n_padded)
        self.halo = w
        # localise columns: device p sees window [p·B − w, (p+1)·B + w)
        shard_of_row = rows_global // B
        local_cols = cols - (shard_of_row[:, None] * B - w)
        # inactive (padded) entries may fall outside the window — clamp to 0
        local_cols = np.where(vals != 0.0, local_cols, 0)
        assert (local_cols >= 0).all() and (local_cols < B + 2 * w).all()

        row_sharding = NamedSharding(mesh, P(axis, None))
        self.cols = jax.device_put(local_cols.astype(np.int32), row_sharding)
        self.vals = jax.device_put(vals, row_sharding)
        self.vec_sharding = NamedSharding(mesh, P(axis))
        axis_name = axis
        halo = w

        def local_spmv(cols_loc, vals_loc, x_loc):
            # assemble extended window [left halo | own | right halo]
            right_src = [(i, (i + 1) % Pn) for i in range(Pn)]  # send to right
            left_src = [(i, (i - 1) % Pn) for i in range(Pn)]  # send to left
            from_left = jax.lax.ppermute(x_loc[-halo:] if halo else x_loc[:0],
                                         axis_name, right_src)
            from_right = jax.lax.ppermute(x_loc[:halo] if halo else x_loc[:0],
                                          axis_name, left_src)
            # zero the wrap-around contributions at the global ends
            idx = jax.lax.axis_index(axis_name)
            from_left = jnp.where(idx == 0, 0.0, from_left)
            from_right = jnp.where(idx == Pn - 1, 0.0, from_right)
            x_ext = jnp.concatenate([from_left, x_loc, from_right])
            return jnp.sum(vals_loc * x_ext[cols_loc], axis=1)

        self._spmv = jax.jit(
            jax.shard_map(
                local_spmv,
                mesh=mesh,
                in_specs=(P(axis, None), P(axis, None), P(axis)),
                out_specs=P(axis),
            )
        )

    def shard_vector(self, x) -> jax.Array:
        x = np.asarray(x)
        if x.shape[0] != self.n_padded:
            x = np.concatenate([x, np.zeros(self.n_padded - x.shape[0], x.dtype)])
        return jax.device_put(x, self.vec_sharding)

    def unshard_vector(self, x: jax.Array) -> np.ndarray:
        return np.asarray(x)[: self.n]

    def matvec(self, x: jax.Array) -> jax.Array:
        return self._spmv(self.cols, self.vals, x)

    def matvec_partial(self) -> jax.tree_util.Partial:
        """See _spmv_partial."""
        return _spmv_partial(self)

    def __matmul__(self, x):
        return self.matvec(x)
