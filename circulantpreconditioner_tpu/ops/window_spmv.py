"""Clustered-window dense SpMV for UNSTRUCTURED meshes.

The reference's PETSc MatMult consumes CSR directly; here a per-element
gather SpMV pays one gather descriptor per nonzero. The FVCA6 tetra fixtures (half the reference's benchmark
ladder, /root/reference/meshes/README.md:22-33) have no grid topology, so the
gather-free stencil paths don't apply. This module re-expresses the assembled
operator so the hardware sees only two fast primitives:

1. Renumber cells bandwidth-tight (host, reverse Cuthill–McKee — done by
   mesh/topology.renumber_bandwidth at load). Consecutive cells then have
   overlapping neighbourhoods.
2. Group G consecutive block rows into a CLUSTER and `unit` consecutive
   block rows into a source UNIT. Per cluster, collect the exact UNION of
   source units its rows touch (welded 3DKershawTetra2 at G=8/unit=2:
   ~28 units max).
3. Store the cluster's rows as ONE dense (G·b, U·unit·b) window matrix W;
   the sparse column structure becomes static zero entries.
4. Apply: gather the U source units per cluster (a row gather of wider
   rows — ~50-100× fewer gather descriptors than element gathers), then
   one batched GEMV
       y[c] = W[c] @ window[c]
   that streams at HBM bandwidth.

`unit` trades gather descriptors against window padding (unit=2: 8-wide
rows, 17% more W traffic than unit=1 at KershawTetra2 scale). The
dense-window "waste" (~15× the true nnz) is paid in streamed bytes instead
of gather descriptors.

Reference parity: this is MatMult of the implicit/explicit drivers on the
tetra fixture families (tests/WaveSystem_SphericalExplosion_impl_seq.cxx:108
KSPSolve inner SpMV; meshes/README.md:30-33 ladder).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclass
class WindowedBlockOperator:
    """y = A x for a block matrix re-laid as per-cluster dense windows.

    x is the flat cell-major vector ((n_cells·b,), cell-interleaved — the
    same layout BSRMatrix.matvec consumes, so this is a drop-in)."""

    n_brows: int
    b: int
    G: int
    unit: int
    src: jax.Array  # (ncl, U) int32 — source UNIT ids per cluster
    W: jax.Array    # (ncl, G·b, U·unit·b) dense window matrices
    n_bcols: int | None = None  # None → square (n_bcols == n_brows)

    def tree_flatten(self):
        return (self.src, self.W), (self.n_brows, self.b, self.G, self.unit,
                                    self.n_bcols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        src, W = children
        return cls(aux[0], aux[1], aux[2], aux[3], src, W,
                   aux[4] if len(aux) > 4 else None)

    @property
    def shape(self) -> tuple[int, int]:
        nc = self.n_bcols if self.n_bcols is not None else self.n_brows
        return (self.n_brows * self.b, nc * self.b)

    @property
    def window_bytes(self) -> int:
        return int(np.prod(self.W.shape)) * self.W.dtype.itemsize

    @classmethod
    def from_block_coo(cls, n_brows: int, brows, bcols, blocks,
                       G: int = 8, unit: int | None = None, dtype=jnp.float32,
                       n_bcols: int | None = None):
        """Build from block-COO (duplicates summed). Host-side, O(nnzb).

        unit=None picks the smallest unit giving ≥ 8 scalars (32 B) per
        gathered row — the descriptor-vs-padding sweet spot measured for
        b=4 (unit=2); scalar operators (b=1) get unit=8 by the same rule.
        n_bcols builds a RECTANGULAR operator (block columns ≠ block rows) —
        the projection matrices of the two-level PCs are the main client."""
        brows = np.asarray(brows, dtype=np.int64)
        bcols = np.asarray(bcols, dtype=np.int64)
        blocks = np.asarray(blocks, dtype=np.float64)
        b = blocks.shape[-1]
        if unit is None:
            unit = max(1, -(-8 // b))
        ncl = -(-n_brows // G)

        order = np.argsort(brows // G, kind="stable")
        brows, bcols, blocks = brows[order], bcols[order], blocks[order]
        cl = brows // G
        ucols = bcols // unit
        starts = np.searchsorted(cl, np.arange(ncl + 1))

        unions = []
        U = 1
        for c in range(ncl):
            u = np.unique(ucols[starts[c]:starts[c + 1]])
            unions.append(u)
            U = max(U, len(u))

        src = np.zeros((ncl, U), dtype=np.int32)
        W = np.zeros((ncl, G * b, U * unit * b), dtype=np.float64)
        n_src = n_bcols if n_bcols is not None else n_brows
        nu_src = max(-(-n_src // unit), 1)
        for c in range(ncl):
            u = unions[c]
            src[c, :len(u)] = u
            # pad slots repeat u[0] (their W entries stay zero so the
            # duplicated gather contributes nothing); a cluster with NO
            # stored blocks points at its own first unit — pointing at unit
            # 0 would inflate the halo width HaloWindowOperator derives from
            # src and spuriously trip its banded-path guard (ADVICE r4)
            fill = u[0] if len(u) else min(c * G // unit, nu_src - 1)
            src[c, len(u):] = fill
            s, e = starts[c], starts[c + 1]
            r = (brows[s:e] - c * G) * b  # local row offset
            k = (np.searchsorted(u, ucols[s:e]) * unit
                 + bcols[s:e] % unit) * b
            for i in range(b):
                for j in range(b):
                    np.add.at(W[c], (r + i, k + j), blocks[s:e, i, j])
        return cls(n_brows, b, G, unit, jnp.asarray(src),
                   jnp.asarray(W, dtype=dtype), n_bcols)

    @classmethod
    def from_bsr(cls, A, G: int = 8, unit: int | None = None, dtype=None):
        return cls.from_block_coo(
            A.n_brows, np.asarray(A.brow_ids), np.asarray(A.indices),
            np.asarray(A.blocks), G=G, unit=unit,
            dtype=dtype or A.blocks.dtype)

    @classmethod
    def from_csr(cls, A, G: int = 8, unit: int | None = None, dtype=None):
        """Scalar (b=1) variant from a CSRMatrix (rectangular supported)."""
        sp = A.to_scipy().tocoo()
        n_rows, n_cols = A.shape
        return cls.from_block_coo(n_rows, sp.row, sp.col,
                                  sp.data.reshape(-1, 1, 1), G=G, unit=unit,
                                  dtype=dtype or A.data.dtype,
                                  n_bcols=None if n_cols == n_rows else n_cols)

    def _gather_windows(self, x: jax.Array):
        """(ncl, U·unit·b[, m]) source windows from x ((n_src·b,) or
        (n_src·b, m))."""
        n_src = self.n_bcols if self.n_bcols is not None else self.n_brows
        ncl = self.src.shape[0]
        nu = -(-n_src // self.unit)
        pad = nu * self.unit * self.b - n_src * self.b
        xp = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1)) if pad else x
        xv = xp.reshape((nu, self.unit * self.b) + x.shape[1:])
        g = xv[self.src]  # (ncl, U, unit·b[, m]) row gather
        return g.reshape((ncl, -1) + x.shape[1:])

    @jax.jit
    def matvec(self, x: jax.Array) -> jax.Array:
        n = self.n_brows * self.b
        win = self._gather_windows(x)
        # HIGHEST: the operator apply must be true-f32 — a reduced-precision
        # matmul tier costs GMRES about twice the iterations; the SpMV is
        # W-streaming-bound so full precision is free
        y = jnp.einsum("cij,cj->ci", self.W, win, precision=jax.lax.Precision.HIGHEST)
        # output rows are padded to whole clusters; trailing pad rows of W
        # are zero so the slice just drops them
        return y.reshape(-1)[:n]

    @jax.jit
    def matvec_multi(self, x: jax.Array) -> jax.Array:
        """y = A X for a MULTIVECTOR x (n_src·b, m) → (n_rows·b, m): one
        batched matmul per cluster, gather rows m× wider than matvec's.
        The block projections of the two-level PCs (nb residual components
        through a scalar P) are the main client — replacing their
        CSRMatrix.matvec element-gather path, which the round-4 profile
        measured at ~0.13 Gnnz/s."""
        n = self.n_brows * self.b
        m = x.shape[1]
        win = self._gather_windows(x)            # (ncl, U·unit·b, m)
        y = jnp.einsum("cij,cjm->cim", self.W, win, precision=jax.lax.Precision.HIGHEST)
        return y.reshape(-1, m)[:n]

    def __call__(self, x):
        return self.matvec(x)

    def matvec_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(WindowedBlockOperator.matvec, self)
