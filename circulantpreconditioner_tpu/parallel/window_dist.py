"""Row-sharded clustered-window SpMV with halo exchange — distributed
unstructured MatMult for the tetra fixture families.

Single-device story: ops/window_spmv.WindowedBlockOperator re-lays an
RCM-ordered unstructured operator as per-cluster dense windows over exact
source-unit unions. This module shards
it the way HaloELLMatrix shards the assembled operator (SURVEY §2.6: PETSc
row-block layout + VecScatter ghost updates):

- clusters are split into P contiguous blocks; each device holds its
  (Bc, G·b, U·unit·b) window slab and (Bc, U) source-unit table,
- after RCM the units a device's clusters reference lie within a halo of
  wu units around its own range, so the source vector needs only two
  ppermute messages of wu unit-rows per apply (ghost update), never an
  all_gather,
- the local apply is the same unit-row gather + batched GEMV as the
  single-device operator, on the halo-extended window.

Reference parity: MatMult inside the parallel KSP of
WaveSystem_SphericalExplosion_impl_mpi.cxx:139-189 on the unstructured
fixture meshes (tests/CMakeLists.txt registers the MPI drivers on
meshCube.med).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from circulantpreconditioner_tpu.ops.window_spmv import WindowedBlockOperator


class HaloWindowOperator:
    """y = A x, row-sharded, for a WindowedBlockOperator-form matrix."""

    def __init__(self, W: WindowedBlockOperator, mesh: Mesh,
                 axis: str = "shard"):
        self.mesh = mesh
        self.axis = axis
        Pn = mesh.shape[axis]
        b, G, unit = W.b, W.G, W.unit
        if G % unit:
            raise ValueError("G must be a multiple of unit for aligned shards")
        src = np.asarray(W.src)
        Wmat = np.asarray(W.W)
        ncl = src.shape[0]
        self.n = W.n_brows * b

        # pad clusters so each device owns Bc of them (extra clusters have
        # zero windows; their src points at their OWN first unit so padding
        # never inflates the halo width)
        Bc = -(-ncl // Pn)
        upc = G // unit                      # units per cluster
        pad = Bc * Pn - ncl
        if pad:
            own_first = (np.arange(ncl, ncl + pad) * upc)[:, None]
            src = np.concatenate(
                [src, np.broadcast_to(own_first, (pad, src.shape[1]))
                 .astype(src.dtype)])
            Wmat = np.concatenate(
                [Wmat, np.zeros((pad,) + Wmat.shape[1:], Wmat.dtype)])
        Bu = Bc * upc                        # units per device
        self.n_units = Bc * Pn * upc
        self.n_padded = self.n_units * unit * b
        self.block_rows = Bc * G * b         # scalar rows per device

        # halo width in units: how far any referenced unit strays from the
        # owning device's unit range
        own_dev = np.repeat(np.arange(Pn), Bc)[:, None]  # device of each cluster
        lo = own_dev * Bu
        hi = lo + Bu
        wu = int(max(np.maximum(lo - src, 0).max(initial=0),
                     np.maximum(src - (hi - 1), 0).max(initial=0)))
        if wu > Bu:
            raise ValueError(
                f"unit halo {wu} exceeds device block {Bu}; RCM bandwidth too "
                "large for one-neighbour exchange — use ShardedELLMatrix")
        self.halo_units = wu
        # localise: device p sees unit window [p·Bu − wu, p·Bu + Bu + wu)
        src_loc = (src - (own_dev * Bu - wu)).astype(np.int32)
        assert (src_loc >= 0).all() and (src_loc < Bu + 2 * wu).all()

        row_sh = NamedSharding(mesh, P(axis, None))
        self.src = jax.device_put(src_loc, row_sh)
        self.W = jax.device_put(Wmat, NamedSharding(mesh, P(axis, None, None)))
        self.vec_sharding = NamedSharding(mesh, P(axis))
        axis_name = axis
        ub = unit * b

        def local_spmv(src_l, W_l, x_loc):
            xu = x_loc.reshape(Bu, ub)
            right = [(i, (i + 1) % Pn) for i in range(Pn)]
            left = [(i, (i - 1) % Pn) for i in range(Pn)]
            from_left = jax.lax.ppermute(xu[-wu:] if wu else xu[:0],
                                         axis_name, right)
            from_right = jax.lax.ppermute(xu[:wu] if wu else xu[:0],
                                          axis_name, left)
            idx = jax.lax.axis_index(axis_name)
            from_left = jnp.where(idx == 0, 0.0, from_left)
            from_right = jnp.where(idx == Pn - 1, 0.0, from_right)
            x_ext = jnp.concatenate([from_left, xu, from_right])
            g = x_ext[src_l]                      # (Bc, U, ub)
            win = g.reshape(Bc, -1)
            y = jnp.einsum("cij,cj->ci", W_l, win, precision=jax.lax.Precision.HIGHEST)
            return y.reshape(-1)

        self._spmv = jax.jit(
            jax.shard_map(
                local_spmv,
                mesh=mesh,
                in_specs=(P(axis, None), P(axis, None, None), P(axis)),
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
        return self._spmv(self.src, self.W, x)

    def matvec_partial(self) -> jax.tree_util.Partial:
        """Operator as a Partial: src/W ride as runtime parameters (see
        spmv_dist._spmv_partial — required on multi-process meshes and for
        recompile-free reuse)."""
        return jax.tree_util.Partial(self._spmv, self.src, self.W)

    def __matmul__(self, x):
        return self.matvec(x)
