"""Distributed preconditioners — circulant projection PC + block Jacobi over
a device mesh, composable with the sharded GMRES.

This is the composition the reference was building toward and never finished:
a preconditioner applied INSIDE a distributed Krylov solve. The reference
runs GMRES+BJACOBI distributed (tests/WaveSystem_SphericalExplosion_impl_mpi
.cxx:32-34, KSPSolve loop :139-189) and its stated end-goal was the FFT
preconditioner inside parallel KSP (ToDo.md:1, src/PCSHELLFft_3D.cxx:10-24,
with FFTW-MPI providing the distributed FFT). Here:

- `sharded_pbjacobi`: point-block Jacobi with the inverted diagonal blocks
  row-sharded exactly like the vector (PCBJACOBI/PBJACOBI analog; zero
  communication per apply).
- `SlabBlockCirculantSolver`: z-slab distributed block-circulant direct
  solve where EVERY transform is a dense matmul on real (re, im) pairs —
  the distributed twin of ops/dft_matmul.MatmulBlockCirculantSolver. One
  all_to_all pair per solve (the y↔z transpose).
- `DistributedBlockCirculantPC`: M⁻¹ = P_back·C⁻¹·P with P/P_back
  row-sharded (cart rows with the z-slabs, cell rows with the vector) and
  the circulant solve slab-sharded — the whole apply is ONE shard_map.
  Communication is four all_to_alls: a personalized halo exchange of the
  residual rows each slab's P rows reference (VecScatter analog), the
  slab solver's y↔z transpose pair, and a halo exchange of the cartesian
  solution rows each device's P_back rows reference. No all-gather — the
  exchanged volume is the projection stencils' footprint, O(N/P + halo)
  per device instead of O(N).

The cartesian grid is derived as in the single-device PC
(solvers/circulant_pc.derive_grid_context, = getFFTPrec3DContext,
PCSHELLFft_3D.cxx:101-151) but with n_z, n_y rounded UP to multiples of the
device count so the slabs and the y↔z transpose tile evenly (grid size is a
free parameter of the PC — finer only helps).
"""

from __future__ import annotations

import warnings

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from circulantpreconditioner_tpu.mesh.core import Mesh as FVMesh
from circulantpreconditioner_tpu.ops.csr import CSRMatrix
from circulantpreconditioner_tpu.ops.dft_matmul import (
    _PRECISIONS,
    _dft_mats,
    _rdft_mats,
)


def _build_exchange(cols: np.ndarray, n_src_blocks: int, Pn: int):
    """Personalized-exchange plan for a row-sharded gather (VecScatter analog,
    SURVEY §2.6: exchange exactly the needed rows, never replicate).

    `cols` is the (n_dst_rows, K) ELL column table of a projection matrix,
    values are global block-row indices into a source vector of
    `n_src_blocks` block rows that is row-sharded contiguously over Pn
    devices. Destination rows are likewise sharded contiguously
    (n_dst_rows % Pn == 0). Returns:

      send_idx   (Pn, Pn, H) int32 — send_idx[j, i] = LOCAL block rows that
                 source device j must send to destination device i (padded
                 with 0; padding is harmless because remapped cols never
                 point at pad slots).
      cols_remap (n_dst_rows, K) int32 — cols rewritten to index the
                 all_to_all receive buffer flattened to (Pn*H,): after
                 device i computes
                     recv = all_to_all(src_loc[send_idx_i], split=0, concat=0)
                 it holds recv.reshape(Pn*H, ...)[cols_remap[r]] ==
                 src[cols[r]] for every destination row r it owns.
      H          int — max rows any device pair exchanges (the halo width).
    """
    n_dst = cols.shape[0]
    if n_src_blocks % Pn or n_dst % Pn:
        raise ValueError("source and destination rows must shard evenly")
    Bs = n_src_blocks // Pn
    Bd = n_dst // Pn
    reqs = []  # reqs[i][j] = sorted unique global cols dest i needs from src j
    H = 1
    for i in range(Pn):
        needed = np.unique(cols[i * Bd:(i + 1) * Bd].ravel())
        owner = needed // Bs
        per_src = [needed[owner == j] for j in range(Pn)]
        reqs.append(per_src)
        H = max(H, max(len(r) for r in per_src))
    send_idx = np.zeros((Pn, Pn, H), np.int32)
    cols_remap = np.empty_like(cols, dtype=np.int32)
    for i in range(Pn):
        # buffer position of each needed global col: j*H + rank within reqs[i][j]
        needed = np.concatenate(reqs[i])          # sorted overall (owners ascend)
        pos = np.concatenate([j * H + np.arange(len(reqs[i][j]), dtype=np.int32)
                              for j in range(Pn)])
        for j in range(Pn):
            rj = reqs[i][j]
            send_idx[j, i, :len(rj)] = rj - j * Bs
        blk = cols[i * Bd:(i + 1) * Bd]
        cols_remap[i * Bd:(i + 1) * Bd] = pos[np.searchsorted(needed, blk)]
    if Pn * H >= n_src_blocks:
        # every pair is padded to the global max halo H, so one skewed
        # projection footprint can inflate the exchange buffer (Pn·H rows per
        # device) past the all_gather volume the halo path is meant to avoid —
        # surface it instead of silently running slower
        warnings.warn(
            f"halo exchange buffer Pn*H = {Pn}*{H} rows >= source size "
            f"{n_src_blocks}: projection footprint is too skewed for the "
            "personalized exchange to beat all_gather (consider halo=False)",
            RuntimeWarning, stacklevel=2)
    return send_idx, cols_remap, H


def _pad_ell(A: CSRMatrix, n_rows_padded: int):
    """Host (cols, vals) ELL arrays padded with zero rows to n_rows_padded."""
    ell = A.to_ell()
    cols = np.asarray(ell.cols)
    vals = np.asarray(ell.vals)
    pad = n_rows_padded - cols.shape[0]
    if pad:
        cols = np.concatenate([cols, np.zeros((pad, cols.shape[1]), cols.dtype)])
        vals = np.concatenate([vals, np.zeros((pad, vals.shape[1]), vals.dtype)])
    return cols.astype(np.int32), vals


def sharded_pbjacobi(Dinv: np.ndarray, n_padded: int, mesh: Mesh,
                     axis: str = "shard", dtype=jnp.float32) -> jax.tree_util.Partial:
    """Point-block Jacobi over a row-sharded padded vector.

    Dinv: (n_brows, b, b) inverted diagonal blocks (e.g. from
    ops/csr.BSRMatrix.block_diagonal() + shift, as in
    solvers/preconditioners.pbjacobi). Padded rows get identity blocks so the
    zero tail stays zero. Requires n_padded % (P·b) == 0 (build the sharded
    operator with row_multiple=b). Apply is purely local — the PETSc
    PCPBJACOBI-in-parallel analog (zero communication)."""
    b = Dinv.shape[-1]
    Pn = mesh.shape[axis]
    if n_padded % (Pn * b):
        raise ValueError(f"n_padded={n_padded} must be a multiple of P·b={Pn * b}")
    nb_pad = n_padded // b
    D = np.tile(np.eye(b), (nb_pad, 1, 1))
    D[: Dinv.shape[0]] = Dinv
    Dj = jax.device_put(D.astype(dtype), NamedSharding(mesh, P(axis, None, None)))

    def local_apply(D_loc, r_loc):
        rb = r_loc.reshape(-1, b)
        return jnp.einsum("nij,nj->ni", D_loc, rb).reshape(-1)

    apply = jax.shard_map(local_apply, mesh=mesh,
                          in_specs=(P(axis, None, None), P(axis)),
                          out_specs=P(axis))
    return jax.tree_util.Partial(apply, Dj)


class SlabBlockCirculantSolver:
    """z-slab distributed block-circulant direct solve, all-matmul.

    Field (nz, ny, nx, m) real, z-slab sharded. Pipeline (all inside one
    shard_map; the only communication is the y↔z all_to_all transpose pair):

        half-spectrum x-DFT (matmul, nx→nxr)     local
        complex y-DFT (matmul)                   local
        all_to_all: split ky, gather z           collective
        complex z-DFT (matmul)                   local
        (m×m) block solve with pre-inverted symbol, sharded on ky
        inverse z-DFT → all_to_all back → inverse y → inverse x

    Replaces the reference's FFTW-MPI slab FFT + packed-real machinery
    (MatCreateFFT on COMM_WORLD + VecPointwiseDivideForRealFFT,
    FftLinearSolver_3D.c:27-77) with two all_to_all transposes and dense
    matmuls.
    Requires nz % P == 0 and ny % P == 0. m=1 gives the scalar solver.
    """

    def __init__(self, shape_zyx, m: int, inv_sym: np.ndarray, mesh: Mesh,
                 axis: str = "shard", dtype=jnp.float32, precision: str = "highest"):
        nz, ny, nx = (int(v) for v in shape_zyx)
        Pn = mesh.shape[axis]
        if nz % Pn or ny % Pn:
            raise ValueError(f"nz={nz} and ny={ny} must be divisible by P={Pn}")
        self.shape_zyx = (nz, ny, nx)
        self.m = int(m)
        self.mesh = mesh
        self.axis = axis
        self.precision = precision
        nxr = nx // 2 + 1
        assert inv_sym.shape == (nz, ny, nxr, m, m), inv_sym.shape

        y_spec = P(None, axis, None, None, None)  # symbol lives post-transpose
        ysh = NamedSharding(mesh, y_spec)
        self.inv_re = jax.device_put(
            np.ascontiguousarray(inv_sym.real).astype(dtype), ysh)
        self.inv_im = jax.device_put(
            np.ascontiguousarray(inv_sym.imag).astype(dtype), ysh)
        F_re, F_im, B_re, B_im = _rdft_mats(nx, dtype)
        Cy, Sy, Cyi, Syi = _dft_mats(ny, dtype)
        Cz, Sz, Czi, Szi = _dft_mats(nz, dtype)
        self._mats = (F_re, F_im, B_re, B_im, Cy, Sy, Cyi, Syi, Cz, Sz, Czi, Szi)
        self.x_sharding = NamedSharding(mesh, P(axis, None, None, None))
        prec = _PRECISIONS[precision]
        axis_name = axis

        def cdft(re, im, C, S, spec):
            ein = lambda v, M: jnp.einsum(spec, v, M, precision=prec,
                                          preferred_element_type=re.dtype)
            return ein(re, C) - ein(im, S), ein(re, S) + ein(im, C)

        def a2a(v, split, concat):
            return jax.lax.all_to_all(v, axis_name, split_axis=split,
                                      concat_axis=concat, tiled=True)

        def local_solve(b_loc, ire, iim, F_re, F_im, B_re, B_im,
                        Cy, Sy, Cyi, Syi, Cz, Sz, Czi, Szi):
            # b_loc (nz/P, ny, nx, m) real
            re = jnp.einsum("zyxm,xk->zykm", b_loc, F_re, precision=prec,
                            preferred_element_type=b_loc.dtype)
            im = jnp.einsum("zyxm,xk->zykm", b_loc, F_im, precision=prec,
                            preferred_element_type=b_loc.dtype)
            re, im = cdft(re, im, Cy, Sy, "zyxm,yk->zkxm")
            re, im = a2a(re, 1, 0), a2a(im, 1, 0)       # (nz, ny/P, nxr, m)
            re, im = cdft(re, im, Cz, Sz, "zyxm,zk->kyxm")
            # block solve: (ire + i·iim) @ (re + i·im)
            re, im = (
                jnp.einsum("...ij,...j->...i", ire, re, precision=prec)
                - jnp.einsum("...ij,...j->...i", iim, im, precision=prec),
                jnp.einsum("...ij,...j->...i", ire, im, precision=prec)
                + jnp.einsum("...ij,...j->...i", iim, re, precision=prec),
            )
            re, im = cdft(re, im, Czi, Szi, "zyxm,zk->kyxm")
            re, im = a2a(re, 0, 1), a2a(im, 0, 1)       # (nz/P, ny, nxr, m)
            re, im = cdft(re, im, Cyi, Syi, "zyxm,yk->zkxm")
            x = jnp.einsum("zykm,kx->zyxm", re, B_re, precision=prec,
                           preferred_element_type=b_loc.dtype) + \
                jnp.einsum("zykm,kx->zyxm", im, B_im, precision=prec,
                           preferred_element_type=b_loc.dtype)
            return x

        self._local_solve = local_solve
        self._solve = jax.jit(
            jax.shard_map(
                local_solve,
                mesh=mesh,
                in_specs=(P(axis, None, None, None), y_spec, y_spec)
                + (P(None, None),) * 12,
                out_specs=P(axis, None, None, None),
            )
        )

    @classmethod
    def from_stencil(cls, shape_zyx, offsets, blocks, mesh: Mesh,
                     axis: str = "shard", dtype=jnp.float32, precision: str = "highest"):
        from circulantpreconditioner_tpu.ops.circulant import BlockCirculantOperator

        shape_zyx = tuple(int(v) for v in shape_zyx)
        m = np.asarray(blocks).shape[-1]
        sym = BlockCirculantOperator.np_symbol(shape_zyx, offsets, blocks)
        nxr = shape_zyx[-1] // 2 + 1
        inv = np.linalg.inv(sym[..., :nxr, :, :])
        return cls(shape_zyx, m, inv, mesh, axis, dtype, precision)

    def shard(self, b) -> jax.Array:
        return jax.device_put(np.asarray(b).reshape(self.shape_zyx + (self.m,)),
                              self.x_sharding)

    def solve(self, b: jax.Array) -> jax.Array:
        """b (nz, ny, nx, m) z-slab sharded (or flat cell-major)."""
        was_flat = b.ndim == 1
        x = self._solve(b.reshape(self.shape_zyx + (self.m,)), self.inv_re,
                        self.inv_im, *self._mats)
        return x.reshape(-1) if was_flat else x


def _derive_slab_grid(mesh: FVMesh, Pn: int):
    """Cartesian PC grid for a device count: n_side per axis as in
    derive_grid_context, with n_z and n_y rounded up to multiples of Pn."""
    from circulantpreconditioner_tpu.solvers.circulant_pc import derive_grid_context

    n_xyz, spacing, _, bbox = derive_grid_context(mesh, [0.0] * mesh.dim, 1.0)
    n_xyz = list(n_xyz)
    dim = mesh.dim
    # zyx axes that must divide: z (slabs) and y (transpose) — in xyz order
    # these are the LAST axis (z) and the one before (y)
    for d in range(max(dim - 2, 0), dim):
        n_xyz[d] = ((n_xyz[d] + Pn - 1) // Pn) * Pn
    spacing = tuple((bbox[d, 1] - bbox[d, 0]) / n_xyz[d] for d in range(dim))
    return tuple(n_xyz), spacing, bbox


class DistributedBlockCirculantPC:
    """Distributed block-circulant projection PC for the wave system:
    M⁻¹ = P_back · C_slab⁻¹ · P, everything sharded, one shard_map per apply.

    The multi-chip flagship composition (reference ToDo.md:1 +
    PCSHELLFft_3D.cxx + the BJACOBI mpi driver): r is the row-sharded
    residual of the sharded GMRES; P's rows (cartesian cells, x-fastest
    flattening) are sharded so each device's rows ARE its z-slab; the slab
    solve runs in place; P_back's rows (unstructured cells) are sharded like
    the vector. Communication per apply (halo=True, the default): a
    personalized all_to_all of the residual rows each slab needs, the y↔z
    all_to_all transpose pair, and a personalized all_to_all of the
    cartesian solution rows each device's P_back rows need — never an
    all-gather (locked by the compiled-HLO test). halo=False keeps the
    replicating all_gather formulation for comparison.

    Use as the coarse term of an additive composite with sharded_pbjacobi
    and side="right" GMRES, exactly like the single-device circulant2l mode
    (solvers/circulant_pc.BlockCirculantProjectionPC notes).
    """

    def __init__(self, fv_mesh: FVMesh, dt: float, c0: float, dmesh: Mesh,
                 n_padded: int, axis: str = "shard", dtype=jnp.float32,
                 samples_per_axis: int = 3, precision: str = "highest",
                 halo: bool = True):
        from circulantpreconditioner_tpu.ops.assembly import wave_block_stencil
        from circulantpreconditioner_tpu.solvers.circulant_pc import (
            build_projection_matrices,
        )

        if fv_mesh.dim != 3:
            raise ValueError("distributed projection PC is 3D (slab axis = z)")
        Pn = dmesh.shape[axis]
        nb = fv_mesh.dim + 1
        if n_padded % (Pn * nb):
            raise ValueError(
                f"n_padded={n_padded} must be a multiple of P·b={Pn * nb} "
                "(build the sharded operator with row_multiple=dim+1)")
        n_xyz, spacing, bbox = _derive_slab_grid(fv_mesh, Pn)
        self.n_xyz = n_xyz
        self.nb = nb
        shape_zyx = tuple(reversed(n_xyz))
        offsets, blocks = wave_block_stencil(fv_mesh.dim, dt, c0, spacing)
        self.solver = SlabBlockCirculantSolver.from_stencil(
            shape_zyx, offsets, blocks, dmesh, axis, dtype, precision)
        Pm, Pb = build_projection_matrices(fv_mesh, n_xyz, bbox,
                                           samples_per_axis, dtype)
        ncart = int(np.prod(n_xyz))
        # P rows = cartesian cells: x-fastest flat order ⇒ contiguous row
        # blocks of ncart/P rows are exactly the z-slabs (nz % P == 0)
        pc_cols, pc_vals = _pad_ell(Pm, ncart)
        # P_back rows = unstructured cells, padded to the vector's block rows
        bk_cols, bk_vals = _pad_ell(Pb, n_padded // nb)
        rsh = NamedSharding(dmesh, P(axis, None))
        self._P = (jax.device_put(pc_cols, rsh),
                   jax.device_put(jnp.asarray(pc_vals, dtype=dtype), rsh))
        self._Pb = (jax.device_put(bk_cols, rsh),
                    jax.device_put(jnp.asarray(bk_vals, dtype=dtype), rsh))

        nz, ny, nx = shape_zyx
        axis_name = axis
        solver = self.solver
        local_solve = solver._local_solve
        y_spec = P(None, axis, None, None, None)

        if halo:
            # Personalized exchanges (all_to_all) of exactly the block rows
            # each peer's projection rows reference — the VecScatter analog —
            # instead of replicating the whole vector / cartesian field.
            fwd_send, pc_cols_h, self.halo_fwd = _build_exchange(
                pc_cols, n_padded // nb, Pn)
            bak_send, bk_cols_h, self.halo_bak = _build_exchange(
                bk_cols, ncart, Pn)
            rsh3 = NamedSharding(dmesh, P(axis, None, None))
            self._plan = (
                jax.device_put(fwd_send, rsh3),
                jax.device_put(pc_cols_h, rsh),
                jax.device_put(bak_send, rsh3),
                jax.device_put(bk_cols_h, rsh),
            )

            def local_apply(fwd_send, pc_cols_h, bak_send, bk_cols_h,
                            pc_vals, bk_vals, ire, iim, *mats_and_r):
                *mats, r_loc = mats_and_r
                rc = r_loc.reshape(-1, nb)                      # local rows
                send = rc[fwd_send[0]]                          # (Pn, H1, nb)
                buf = jax.lax.all_to_all(send, axis_name, split_axis=0,
                                         concat_axis=0, tiled=True)
                buf = buf.reshape(-1, nb)                       # (Pn*H1, nb)
                r_cart = jnp.einsum("rk,rkm->rm", pc_vals, buf[pc_cols_h])
                b_slab = r_cart.reshape(nz // Pn, ny, nx, nb)
                x_slab = local_solve(b_slab, ire, iim, *mats)
                xc = x_slab.reshape(-1, nb)                     # local slab
                send2 = xc[bak_send[0]]                         # (Pn, H2, nb)
                buf2 = jax.lax.all_to_all(send2, axis_name, split_axis=0,
                                          concat_axis=0, tiled=True)
                buf2 = buf2.reshape(-1, nb)                     # (Pn*H2, nb)
                out = jnp.einsum("rk,rkm->rm", bk_vals, buf2[bk_cols_h])
                return out.reshape(-1)

            self._apply_sm = jax.shard_map(
                local_apply,
                mesh=dmesh,
                in_specs=(P(axis, None, None), P(axis, None),
                          P(axis, None, None), P(axis, None),
                          P(axis, None), P(axis, None), y_spec, y_spec)
                + (P(None, None),) * 12 + (P(axis),),
                out_specs=P(axis),
            )
            self.apply = jax.tree_util.Partial(
                self._apply_sm, *self._plan, self._P[1], self._Pb[1],
                solver.inv_re, solver.inv_im, *solver._mats)
            return

        def local_apply(pc_cols, pc_vals, bk_cols, bk_vals,
                        ire, iim, *mats_and_r):
            *mats, r_loc = mats_and_r
            r_full = jax.lax.all_gather(r_loc, axis_name, tiled=True)
            rc = r_full.reshape(-1, nb)            # (n_padded/nb, nb)
            r_cart = jnp.einsum("rk,rkm->rm", pc_vals, rc[pc_cols])
            b_slab = r_cart.reshape(nz // Pn, ny, nx, nb)
            x_slab = local_solve(b_slab, ire, iim, *mats)
            x_full = jax.lax.all_gather(x_slab.reshape(-1, nb), axis_name,
                                        tiled=True)  # (ncart, nb)
            out = jnp.einsum("rk,rkm->rm", bk_vals, x_full[bk_cols])
            return out.reshape(-1)

        self._apply_sm = jax.shard_map(
            local_apply,
            mesh=dmesh,
            in_specs=(P(axis, None), P(axis, None), P(axis, None),
                      P(axis, None), y_spec, y_spec)
            + (P(None, None),) * 12 + (P(axis),),
            out_specs=P(axis),
        )
        self.apply = jax.tree_util.Partial(
            self._apply_sm, *self._P, *self._Pb,
            solver.inv_re, solver.inv_im, *solver._mats)

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)
