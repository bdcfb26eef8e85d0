"""Structured-grid stencil operators — gather-free SpMV for cartesian meshes.

The assembled-matrix SpMV (gather + segment-sum / ELL) pays for
irregular addressing the FV operator doesn't actually have on a structured
grid: the wave/transport divergence is a 7-point (block) stencil with ONE
coefficient (block) per face direction. This module evaluates D·U as

    D U = Σ_{sides s=(axis,dir)} (U_nb(s) − U) · Amᵀ(s)

with `jnp.roll` shifts, boundary-layer masks for Wall/Neumann (mirror ghost
U_nb = (I − 2vvᵀ)U for walls, WaveSystem.cxx:150-157), and per-side (b×b)
blocks contracted as batched matmuls. Pure shifts + batched matmuls: compiles in
seconds and streams at HBM bandwidth — the structured-mesh fast path the
reference's generic PETSc SpMV can't express.

Equivalence with ops/assembly.py matrices is asserted in tests/test_stencil.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.ops.assembly import wave_jacobian_blocks


def _side_tables(dim: int, dt: float, c0: float, spacing, bc: str):
    """Per-side upwind blocks Am and wall mirrors for the wave system.

    Sides are (axis_zyx, dir) with dir=+1 the face whose outward normal is
    +e_axis. Returns (Am (nsides,b,b), mirror (nsides,b,b))."""
    h = np.asarray(spacing, dtype=np.float64)[:dim]
    nb = dim + 1
    Ams, mirrors = [], []
    for ax_zyx in range(dim):  # axis in zyx array order
        d_xyz = dim - 1 - ax_zyx
        for sgn in (+1.0, -1.0):
            e = np.zeros((1, dim))
            e[0, d_xyz] = sgn
            A, absA = wave_jacobian_blocks(e, c0)
            Am = 0.5 * (A[0] - absA[0]) * (dt / h[d_xyz])
            v = np.zeros(nb)
            v[1:] = e[0]
            mirror = np.eye(nb) - 2.0 * np.outer(v, v)
            Ams.append(Am)
            mirrors.append(mirror)
    return np.stack(Ams), np.stack(mirrors)


@jax.tree_util.register_pytree_node_class
@dataclass
class WaveStencilOperator:
    """D of the wave system on a uniform cartesian grid, stencil-evaluated.

    bc: "wall" (reference default — mirror ghosts) or "periodic".
    State layout: flat cell-major (N·(dim+1),), zyx x-fastest — identical to
    the assembled BSRMatrix, so `matvec` is a drop-in replacement.
    """

    shape_zyx: tuple[int, ...]
    bc: str
    Am: jax.Array  # (2·dim, b, b)
    mirror: jax.Array  # (2·dim, b, b)

    def tree_flatten(self):
        return (self.Am, self.mirror), (self.shape_zyx, self.bc)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], *children)

    @classmethod
    def create(cls, shape_xyz: Sequence[int], dt: float, c0: float, spacing_xyz,
               bc: str = "wall", dtype=jnp.float32):
        dim = len(shape_xyz)
        Am, mirror = _side_tables(dim, dt, c0, spacing_xyz, bc)
        return cls(
            tuple(reversed(tuple(int(v) for v in shape_xyz))),
            bc,
            jnp.asarray(Am, dtype=dtype),
            jnp.asarray(mirror, dtype=dtype),
        )

    @classmethod
    def from_model(cls, model, bc: str = "wall"):
        mesh = model.mesh
        return cls.create(mesh.structured_shape, model.dt, model.c0,
                          mesh.spacing, bc=bc, dtype=model.dtype)

    @property
    def nb(self) -> int:
        return len(self.shape_zyx) + 1

    @jax.jit
    def matvec(self, U: jax.Array) -> jax.Array:
        """y = D U (divergence only — apply I+D for the implicit system)."""
        dim = len(self.shape_zyx)
        nb = self.nb
        g = U.reshape(self.shape_zyx + (nb,))
        out = jnp.zeros_like(g)
        s = 0
        for ax in range(dim):
            n = self.shape_zyx[ax]
            for sgn in (+1, -1):
                # neighbour in +sgn direction along array axis `ax`
                nbr = jnp.roll(g, -sgn, axis=ax)
                if self.bc != "periodic":
                    # boundary layer: the face at the domain edge has no
                    # neighbour → wall mirror ghost (I − 2vvᵀ)U
                    edge = n - 1 if sgn > 0 else 0
                    idx = jax.lax.broadcasted_iota(jnp.int32, g.shape, ax)
                    ghost = jnp.einsum("...j,ij->...i", g, self.mirror[s], precision=jax.lax.Precision.HIGHEST)
                    nbr = jnp.where(idx == edge, ghost, nbr)
                out = out + jnp.einsum("...j,ij->...i", nbr - g, self.Am[s], precision=jax.lax.Precision.HIGHEST)
                s += 1
        return out.reshape(-1)

    def __call__(self, U):
        return self.matvec(U)

    def matvec_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(WaveStencilOperator.matvec, self)


@jax.tree_util.register_pytree_node_class
@dataclass
class TransportStencilOperator:
    """Scalar upwind divergence D on a uniform cartesian grid.

    bc: "periodic" (circulant case) or "neumann" (reference transport
    drivers: boundary faces contribute nothing)."""

    shape_zyx: tuple[int, ...]
    bc: str
    lam_plus: tuple[float, ...]  # λ⁺ per zyx axis = max(a_d,0)·dt/h_d
    lam_minus: tuple[float, ...]  # λ⁻ per zyx axis = min(a_d,0)·dt/h_d

    def tree_flatten(self):
        return (), (self.shape_zyx, self.bc, self.lam_plus, self.lam_minus)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux)

    @classmethod
    def create(cls, shape_xyz: Sequence[int], velocity_xyz, dt: float, spacing_xyz,
               bc: str = "periodic"):
        dim = len(shape_xyz)
        a = np.asarray(velocity_xyz, dtype=np.float64)[:dim]
        h = np.asarray(spacing_xyz, dtype=np.float64)[:dim]
        lam = a * dt / h  # xyz order
        lam_zyx = lam[::-1]
        return cls(
            tuple(reversed(tuple(int(v) for v in shape_xyz))),
            bc,
            tuple(float(max(l, 0.0)) for l in lam_zyx),
            tuple(float(min(l, 0.0)) for l in lam_zyx),
        )

    @jax.jit
    def matvec(self, u: jax.Array) -> jax.Array:
        """y = D u, matching ops/assembly.transport_divergence_csr exactly.

        Per axis with λ = a·dt/h. For λ>0 (flow in +direction): cell j's
        outflow (+) face gives +λ·u_j when interior (j<n−1), its inflow (−)
        face gives −λ·u_{j−1} when interior (j≥1); Neumann boundary faces
        contribute nothing (TransportEquation.cxx behaviour). Periodic keeps
        both terms with wraparound. Mirrored for λ<0.
        """
        g = u.reshape(self.shape_zyx)
        out = jnp.zeros_like(g)
        for ax, (lp, lm) in enumerate(zip(self.lam_plus, self.lam_minus)):
            n = self.shape_zyx[ax]
            idx = jax.lax.broadcasted_iota(jnp.int32, g.shape, ax)
            if lp:
                up = jnp.roll(g, 1, axis=ax)  # u_{j−1} (wraps)
                if self.bc == "periodic":
                    out = out + lp * (g - up)
                else:
                    out = out + lp * (
                        jnp.where(idx < n - 1, g, 0.0) - jnp.where(idx >= 1, up, 0.0)
                    )
            if lm:
                dn = jnp.roll(g, -1, axis=ax)  # u_{j+1} (wraps)
                if self.bc == "periodic":
                    out = out - lm * (g - dn)
                else:
                    out = out - lm * (
                        jnp.where(idx >= 1, g, 0.0) - jnp.where(idx < n - 1, dn, 0.0)
                    )
        return out.reshape(-1)

    def matvec_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(TransportStencilOperator.matvec, self)


@jax.tree_util.register_pytree_node_class
@dataclass
class VaryingStencilOperator:
    """Gather-free SpMV for TOPOLOGICALLY structured meshes with varying
    coefficients (the warped Kershaw/hexa FVCA6 families): the assembled
    CSR/BSR operator is re-expressed as per-offset dense coefficient fields

        y[c] = Σ_off  C_off[c] @ x[c + off],   off ∈ {0, ±ex, ±ey, ±ez}

    and applied with jnp.roll shifts + batched (m×m) einsum contractions —
    no gathers, streams at HBM bandwidth with batched block contractions.
    This replaces the reference's generic PETSc MatMult on its
    Kershaw benchmark meshes (meshes/README.md:30-40): the topology is a
    grid even when the geometry is not.

    Wall/Neumann boundaries need no masks: the assembled matrix simply has
    zero blocks on the outward-facing boundary layers, so wrapped roll
    values are multiplied by zero. Periodic wrap IS the roll. Hence exact
    equality with the assembled matvec by construction (tests/test_stencil).

    `cells_per_site` > 1 groups consecutive cells into one grid SITE
    (supercell): the FVCA6 tetra family is 6 tets per hex in hex-major
    numbering, so with cells_per_site=6 each site block is (6m × 6m) and
    inter-site coupling stays a 7-point stencil — the tet meshes get the
    gather-free path too, at the cost of the dense-block zero padding.
    """

    shape_zyx: tuple[int, ...]
    m: int
    offsets: tuple  # static: zyx tuples (grid layouts) or flat ints ("flat")
    coefs: tuple  # per-offset coefficient arrays (layout-dependent)
    # Layouts, fastest first:
    # - "flat": coefs (m, m, N) with the WHOLE grid as the minor axis (full
    #   128-lane packing regardless of nx/ny — a (32,32)-trailing grid wastes
    #   75% of every tile) and neighbor access as a single flat roll. Valid
    #   when every wrap-crossing boundary layer has zero coefficients
    #   (wall/Neumann assemblies) — detected at build time.
    # - "grid_last": coefs (m, m, *shape_zyx), per-axis rolls — needed for
    #   periodic wraps. Both layouts contract the blocks as unrolled VPU
    #   multiply-adds for m ≤ 8 and as one grid-minor einsum for larger
    #   supercell blocks (4.9× the legacy trailing-(M,M) batched form).
    # - "block": coefs (*shape_zyx, m, m) — legacy trailing-block form,
    #   still applied but no longer produced by from_blocks.
    layout: str = "flat"

    def tree_flatten(self):
        return (self.coefs,), (self.shape_zyx, self.m, self.offsets, self.layout)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], aux[2], children[0], aux[3])

    @classmethod
    def from_blocks(cls, rows, cols, blocks, shape_xyz, dtype=jnp.float32,
                    cells_per_site: int = 1):
        """rows/cols: block indices (nnzb,), blocks: (nnzb, m, m) — e.g. a
        BSR's expanded COO. shape_xyz: SITE-grid shape, x-fastest numbering;
        cells_per_site consecutive block rows form one site."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        blocks = np.asarray(blocks)
        m = blocks.shape[-1]
        g = int(cells_per_site)
        dims_xyz = tuple(int(v) for v in shape_xyz)
        nx = dims_xyz[0]
        ny = dims_xyz[1] if len(dims_xyz) > 1 else 1
        nz = dims_xyz[2] if len(dims_xyz) > 2 else 1

        site_r, sub_r = rows // g, rows % g
        site_c, sub_c = cols // g, cols % g

        def split(idx):
            return idx % nx, (idx // nx) % ny, idx // (nx * ny)

        rx, ry, rz = split(site_r)
        cx, cy, cz = split(site_c)

        def delta(a, b, n):
            d = (b - a) % n
            out = np.where(d == 0, 0, np.where(d == 1, 1, np.where(d == n - 1, -1, 99)))
            return out

        dx, dy, dz = delta(rx, cx, nx), delta(ry, cy, ny), delta(rz, cz, nz)
        if (np.abs(dx) > 1).any() or (np.abs(dy) > 1).any() or (np.abs(dz) > 1).any():
            raise ValueError("matrix is not a face-neighbour stencil on this grid")
        if ((dx != 0).astype(int) + (dy != 0).astype(int) + (dz != 0).astype(int) > 1).any():
            raise ValueError("matrix couples diagonal neighbours — not a 7-point stencil")

        shape_zyx = (nz, ny, nx)
        M = g * m
        # flat (preferred, below) or grid_last for wrap-coupled meshes; the
        # legacy trailing-(M,M) "block" layout is no longer produced — large
        # blocks are handled by the einsum path in _apply_gt
        layout = "grid_last"
        key = (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)
        offsets, coefs_np = [], []
        for k in np.unique(key):
            sel = key == k
            # (site grid, sub_r, sub_c, m, m) — transposed/reshaped to (M, M)
            C = np.zeros(shape_zyx + (g, g, m, m), dtype=np.float64)
            np.add.at(C, (rz[sel], ry[sel], rx[sel], sub_r[sel], sub_c[sel]), blocks[sel])
            C = C.transpose(0, 1, 2, 3, 5, 4, 6).reshape(shape_zyx + (M, M))
            off_zyx = (int(k) // 9 - 1, (int(k) // 3) % 3 - 1, int(k) % 3 - 1)
            offsets.append(off_zyx)
            coefs_np.append(C)

        if cls._flat_safe(offsets, coefs_np, shape_zyx):
            # wrap-crossing layers all zero → flat rolls are exact
            strides = (ny * nx, nx, 1)
            flat_offsets = tuple(
                int(sum(o * s for o, s in zip(off, strides))) for off in offsets
            )
            coefs = tuple(
                jnp.asarray(
                    np.ascontiguousarray(
                        C.reshape(-1, M, M).transpose(1, 2, 0)), dtype=dtype)
                for C in coefs_np
            )
            return cls(shape_zyx, M, flat_offsets, coefs, "flat")
        coefs = tuple(
            jnp.asarray(np.ascontiguousarray(C.transpose(3, 4, 0, 1, 2)),
                        dtype=dtype)
            for C in coefs_np
        )
        return cls(shape_zyx, M, tuple(offsets), coefs, layout)

    @staticmethod
    def _flat_safe(offsets, coefs_np, shape_zyx) -> bool:
        """True when, for every offset, the cells whose neighbor would wrap
        around an axis carry an all-zero coefficient block (wall/Neumann
        assemblies): a flat roll then differs from the per-axis rolls only
        where it is multiplied by zero."""
        for off, C in zip(offsets, coefs_np):
            for ax, o in enumerate(off):
                if o == 0:
                    continue
                idx = [slice(None)] * 3
                idx[ax] = shape_zyx[ax] - 1 if o > 0 else 0
                if np.any(C[tuple(idx)]):
                    return False
        return True

    @classmethod
    def from_csr(cls, A, shape_xyz, dtype=None, cells_per_site: int = 1):
        """Scalar (m=1) variant from a CSRMatrix."""
        sp = A.to_scipy().tocoo()
        return cls.from_blocks(sp.row, sp.col, sp.data.reshape(-1, 1, 1), shape_xyz,
                               dtype=dtype or A.data.dtype,
                               cells_per_site=cells_per_site)

    @classmethod
    def from_bsr(cls, A, shape_xyz, dtype=None, cells_per_site: int = 1):
        """Block variant from a BSRMatrix (block COO layout)."""
        return cls.from_blocks(np.asarray(A.brow_ids), np.asarray(A.indices),
                               np.asarray(A.blocks), shape_xyz,
                               dtype=dtype or A.blocks.dtype,
                               cells_per_site=cells_per_site)

    # unroll the m² multiply-adds only for small blocks; large supercell
    # blocks (tet: M=24 → 576 terms) stay ONE einsum
    _UNROLL_MAX = 8

    def _apply_gt(self, gt):
        """Core apply on the field-major representation gt (m, N) [flat] or
        (m, *grid) [grid_last]; returns the list of m output components."""
        m = self.m
        flat = self.layout == "flat"
        ys = [jnp.zeros(gt.shape[1:], gt.dtype) for _ in range(m)]
        for off, C in zip(self.offsets, self.coefs):
            if flat:
                nbr = jnp.roll(gt, -off, axis=1) if off else gt
            else:
                nbr = gt
                for ax, o in enumerate(off):
                    if o:
                        nbr = jnp.roll(nbr, -o, axis=ax + 1)
            if m > self._UNROLL_MAX:
                # true-f32 operator apply: a reduced-precision default
                # matmul tier (TF32 on an H100) degrades Krylov convergence
                upd = jnp.einsum("ij...,j...->i...", C, nbr, precision=jax.lax.Precision.HIGHEST)
                for i in range(m):
                    ys[i] = ys[i] + upd[i]
                continue
            for i in range(m):
                acc = ys[i]
                for j in range(m):
                    acc = acc + C[i, j] * nbr[j]
                ys[i] = acc
        return ys

    @jax.jit
    def matvec(self, x: jax.Array) -> jax.Array:
        m = self.m
        if self.layout == "flat":
            N = int(np.prod(self.shape_zyx))
            gt = x.reshape(N, m).T  # (m, N): whole grid on the lane axis
            return jnp.stack(self._apply_gt(gt), axis=1).reshape(-1)
        if self.layout == "grid_last":
            gt = jnp.moveaxis(x.reshape(self.shape_zyx + (m,)), -1, 0)  # (m, grid)
            return jnp.moveaxis(jnp.stack(self._apply_gt(gt)), 0, -1).reshape(-1)
        g = x.reshape(self.shape_zyx + (m,))
        out = jnp.zeros_like(g)
        for off, C in zip(self.offsets, self.coefs):
            nbr = g
            for ax, o in enumerate(off):
                if o:
                    nbr = jnp.roll(nbr, -o, axis=ax)
            out = out + jnp.einsum("...ij,...j->...i", C, nbr, precision=jax.lax.Precision.HIGHEST)
        return out.reshape(-1)

    @jax.jit
    def matvec_fm(self, g: jax.Array) -> jax.Array:
        """FIELD-MAJOR apply: g (m, N) [flat] or (m, *grid) [grid_last] →
        same shape. Identical arithmetic to `matvec` minus the
        (N,m)↔(m,N) relayouts, which can dominate the cell-major apply
        (the transposes cost more than the whole stencil body — keep the
        state field-major across a time loop and pay them once per I/O,
        not per matvec)."""
        if self.layout not in ("flat", "grid_last"):
            raise ValueError("matvec_fm supports flat/grid_last layouts")
        return jnp.stack(self._apply_gt(g))

    def __call__(self, x):
        return self.matvec(x)

    @jax.jit
    def matvec_fm_flat(self, x: jax.Array) -> jax.Array:
        """Field-major apply on a FLAT (m·N,) vector (x.reshape(m, ...) is
        the field view) — for Krylov solvers whose vectors are 1D."""
        m = self.m
        shp = ((m, -1) if self.layout == "flat"
               else (m,) + self.shape_zyx)
        return self.matvec_fm(x.reshape(shp)).reshape(-1)

    def matvec_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(VaryingStencilOperator.matvec, self)

    def matvec_fm_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(VaryingStencilOperator.matvec_fm, self)

    def matvec_fm_flat_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(VaryingStencilOperator.matvec_fm_flat, self)


@jax.tree_util.register_pytree_node_class
@dataclass
class SupercellStencilOperator:
    """Block-SPARSE supercell stencil SpMV for cells_per_site > 1 meshes
    (the FVCA6 tetra generator: 6 tets per hex, site blocks 24×24).

    The dense supercell form (VaryingStencilOperator, M=24 einsum path)
    streams 7 offsets × 24×24 coefficients per site — but ~6/7 of those
    entries are structural zeros: inside a hex only 6 of the 15 tet pairs
    share a face (18 of 36 sub-blocks incl. diagonals are nonzero), and a
    hex face split into 2 triangles couples exactly 2 tet pairs per
    neighbour offset. This class stores, per offset, only the nonzero
    (sub_row, sub_col) 4×4 sub-blocks — detected from the assembled
    coefficients at build, so any supercell pattern works — cutting the
    coefficient traffic ~8× (4032 → ~480+dense-diag scalars per site).
    Apply = one flat roll per offset + unrolled 4×4 multiply-adds on
    (N_sites,)-lane vectors, same gather-free contract as the parent.
    Exact by construction: sub-blocks are the parent's coefficients.

    Reference parity: MatMult on the 3DTetrahedra fixture family ladder
    (meshes/README.md:22-26)."""

    shape_zyx: tuple[int, ...]
    m: int  # per-cell block size (dim+1)
    g: int  # cells per site
    offsets: tuple  # flat ints, diag included
    pair_idx: tuple  # per offset: tuple of (sub_r, sub_c) with data
    coefs: tuple  # per offset: (npairs, m, m, N) arrays

    def tree_flatten(self):
        return (self.coefs,), (self.shape_zyx, self.m, self.g, self.offsets,
                               self.pair_idx)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], aux[2], aux[3], aux[4], children[0])

    @property
    def M(self) -> int:
        return self.m * self.g

    @classmethod
    def from_varying(cls, V: "VaryingStencilOperator", m: int, g: int,
                     tol: float = 0.0):
        """Decompose a flat-layout supercell VaryingStencilOperator
        (V.m == m·g) into its nonzero 4×4 sub-block structure. None if V
        is not in the flat supercell form."""
        if V.layout != "flat" or V.m != m * g:
            return None
        offsets, pair_idx, coefs = [], [], []
        for off, C in zip(V.offsets, V.coefs):
            Cn = np.asarray(C)  # (M, M, N)
            pairs = []
            mats = []
            for sr in range(g):
                for sc in range(g):
                    sub = Cn[sr * m:(sr + 1) * m, sc * m:(sc + 1) * m]
                    if np.abs(sub).max() > tol:
                        pairs.append((sr, sc))
                        mats.append(sub)
            if not pairs:
                continue
            offsets.append(int(off))
            pair_idx.append(tuple(pairs))
            coefs.append(jnp.asarray(np.stack(mats), dtype=C.dtype))
        return cls(V.shape_zyx, m, g, tuple(offsets), tuple(pair_idx),
                   tuple(coefs))

    def _apply_gt(self, gt):
        """gt (M, N_sites) field-major; returns list of M outputs."""
        m = self.m
        ys = [jnp.zeros(gt.shape[1:], gt.dtype) for _ in range(self.M)]
        for off, pairs, C in zip(self.offsets, self.pair_idx, self.coefs):
            nbr = jnp.roll(gt, -off, axis=1) if off else gt
            for p, (sr, sc) in enumerate(pairs):
                for i in range(m):
                    acc = ys[sr * m + i]
                    for j in range(m):
                        acc = acc + C[p, i, j] * nbr[sc * m + j]
                    ys[sr * m + i] = acc
        return ys

    @jax.jit
    def matvec_fm(self, g: jax.Array) -> jax.Array:
        """Field-major apply: g (M, N_sites) → same shape."""
        return jnp.stack(self._apply_gt(g))

    @jax.jit
    def matvec_fm_flat(self, x: jax.Array) -> jax.Array:
        return self.matvec_fm(x.reshape(self.M, -1)).reshape(-1)

    @jax.jit
    def matvec(self, x: jax.Array) -> jax.Array:
        """Cell-major flat apply (site-interleaved rows, like the BSR)."""
        N = int(np.prod(self.shape_zyx))
        gt = x.reshape(N, self.M).T
        return jnp.stack(self._apply_gt(gt), axis=1).reshape(-1)

    def __call__(self, x):
        return self.matvec(x)

    def matvec_fm_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(SupercellStencilOperator.matvec_fm, self)

    def matvec_fm_flat_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(SupercellStencilOperator.matvec_fm_flat, self)

    def matvec_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(SupercellStencilOperator.matvec, self)


@jax.tree_util.register_pytree_node_class
@dataclass
class WaveNormalStencilOperator:
    """Physics-structured wave-system SpMV: the off-diagonal upwind blocks
    are rank-structured, Am = s·(A − |A|)(n̂)/2 with
    A=[[0, c0²n̂ᵀ],[n̂, 0]], |A|=[[c0, 0],[0, c0·n̂n̂ᵀ]]
    (reference jacobianMatrices, src/WaveSystem.cxx:92-107), so each
    neighbour block is 1+dim numbers (s, n̂) instead of (dim+1)² — 2.8×
    less HBM traffic than the dense varying stencil in 3D, applied as

        t = n̂·v_nbr
        out_p   += s·c0·(c0·t − p_nbr)/2
        out_vec += s·(p_nbr − c0·t)/2 · n̂

    The diagonal block keeps its dense form (it accumulates wall-mirror
    terms and face sums with no common structure). Built by exact
    decomposition of a VaryingStencilOperator's blocks (flat or grid_last
    layout) — construction FAILS (returns None) if any block deviates from
    the wave form, so correctness never silently degrades.
    """

    shape_zyx: tuple[int, ...]
    c0: float
    offsets: tuple  # flat ints or zyx tuples, matching `layout`; diag excluded
    layout: str  # "flat" or "grid_last"
    arrays: tuple  # (diag, s (K,...), nvec (K,dim,...)) — grid dims trailing

    def tree_flatten(self):
        return (self.arrays,), (self.shape_zyx, self.c0, self.offsets, self.layout)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], aux[2], aux[3], children[0])

    @property
    def m(self) -> int:
        return self.arrays[0].shape[0]

    @classmethod
    def from_varying(cls, V: "VaryingStencilOperator", c0: float,
                     rtol: float = 1e-5):
        """Exact decomposition; None if V isn't a wave-form stencil."""
        if V.layout not in ("flat", "grid_last"):
            return None
        m = V.m
        dim = m - 1
        if dim not in (1, 2, 3):
            return None
        diag = None
        offs, s_list, n_list = [], [], []
        diag_key = 0 if V.layout == "flat" else (0,) * len(V.shape_zyx)
        for off, C in zip(V.offsets, V.coefs):
            C = np.asarray(C, dtype=np.float64).reshape(m, m, -1)
            if off == diag_key:
                diag = C
                continue
            s = -2.0 * C[0, 0] / c0
            sn = 2.0 * C[1:, 0]
            safe = np.where(np.abs(s) > 0, s, 1.0)
            n = sn / safe
            scale = np.abs(C).max() + 1e-300
            err = np.abs(C[0, 1:] - 0.5 * c0 * c0 * sn).max()
            err = max(err, np.abs(
                C[1:, 1:] + 0.5 * c0 * s * n[:, None, :] * n[None, :, :]
            ).max())
            if err > rtol * scale:
                return None
            offs.append(off)
            s_list.append(s)
            n_list.append(n)
        if diag is None:
            return None
        dtype = V.coefs[0].dtype
        grid = V.shape_zyx
        if V.layout == "grid_last":
            shp = grid
        else:
            shp = (int(np.prod(grid)),)
        arrays = (
            jnp.asarray(diag.reshape((m, m) + shp), dtype=dtype),
            jnp.asarray(np.stack(s_list).reshape((len(offs),) + shp), dtype=dtype),
            jnp.asarray(np.stack(n_list).reshape((len(offs), dim) + shp), dtype=dtype),
        )
        return cls(V.shape_zyx, float(c0), tuple(offs), V.layout, arrays)

    def _apply_gt(self, gt):
        """Core apply on the field-major representation; returns m outputs."""
        diag, s, nvec = self.arrays
        m = self.m
        dim = m - 1
        flat = self.layout == "flat"
        ys = []
        for i in range(m):
            acc = diag[i, 0] * gt[0]
            for j in range(1, m):
                acc = acc + diag[i, j] * gt[j]
            ys.append(acc)
        half_c0 = 0.5 * self.c0
        for k, off in enumerate(self.offsets):
            if flat:
                nbr = jnp.roll(gt, -off, axis=1)
            else:
                nbr = gt
                for ax, o in enumerate(off):
                    if o:
                        nbr = jnp.roll(nbr, -o, axis=ax + 1)
            p = nbr[0]
            t = nvec[k, 0] * nbr[1]
            for d in range(1, dim):
                t = t + nvec[k, d] * nbr[1 + d]
            u = s[k] * (0.5 * p - half_c0 * t)  # s·(p − c0·t)/2
            ys[0] = ys[0] + half_c0 * s[k] * (self.c0 * t - p)
            for d in range(dim):
                ys[1 + d] = ys[1 + d] + u * nvec[k, d]
        return ys

    @jax.jit
    def matvec(self, x: jax.Array) -> jax.Array:
        m = self.m
        if self.layout == "flat":
            N = int(np.prod(self.shape_zyx))
            gt = x.reshape(N, m).T  # (m, N)
            return jnp.stack(self._apply_gt(gt), axis=1).reshape(-1)
        gt = jnp.moveaxis(x.reshape(self.shape_zyx + (m,)), -1, 0)
        return jnp.moveaxis(jnp.stack(self._apply_gt(gt)), 0, -1).reshape(-1)

    @jax.jit
    def matvec_fm(self, g: jax.Array) -> jax.Array:
        """FIELD-MAJOR apply: g (m, N) [flat] / (m, *grid) [grid_last] →
        same shape. Same arithmetic as `matvec` without the (N,m)↔(m,N)
        relayouts, which can cost more than the stencil body itself, so
        production loops should keep the state field-major and convert only
        at I/O boundaries."""
        return jnp.stack(self._apply_gt(g))

    def __call__(self, x):
        return self.matvec(x)

    @jax.jit
    def matvec_fm_flat(self, x: jax.Array) -> jax.Array:
        """Field-major apply on a FLAT (m·N,) vector (see
        VaryingStencilOperator.matvec_fm_flat)."""
        m = self.m
        shp = ((m, -1) if self.layout == "flat"
               else (m,) + self.shape_zyx)
        return self.matvec_fm(x.reshape(shp)).reshape(-1)

    def matvec_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(WaveNormalStencilOperator.matvec, self)

    def matvec_fm_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(WaveNormalStencilOperator.matvec_fm, self)

    def matvec_fm_flat_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(WaveNormalStencilOperator.matvec_fm_flat, self)
