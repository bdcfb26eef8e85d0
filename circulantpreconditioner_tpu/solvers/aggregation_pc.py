"""Aggregation multilevel (V-cycle) preconditioner for warped unstructured
meshes — the adaptive coarse space the cartesian projection PC cannot be.

Round-4 measured negative result: every geometric-sampling projection onto a
cartesian surrogate grid is neutral-to-divergent on the strongly warped FVCA6
fixtures (3DKershawTetra*, Kershaw2.med — the meshes the reference's own
benchmark ladder anchors on, /root/reference/meshes/README.md:22-40), leaving
point-block Jacobi as the only working PC there (186 its at KTetra2). This
module replaces the *geometric* surrogate with an *algebraic* one: the coarse
operators are Galerkin restrictions of the true assembled operator, so they
are exact on the coarse space regardless of how warped the geometry is.

Design (all choices measured on 3DKershawTetra1, scipy prototype, GMRES
tol 1e-5 vs pbjacobi 291 its):

- **Contiguous aggregation**: cells are already RCM-ordered at load
  (mesh/topology.renumber_bandwidth), so consecutive index chunks of
  `factor` cells are face-coherent aggregates. Measured equal to greedy
  BFS aggregation (88 vs 89 its two-level) — and the grid-transfer
  operators collapse to reshape/broadcast with ZERO gathers on device.
- **Piecewise-constant P, mean R** (R·P = I). Smoothed prolongators
  (I − ωD⁻¹A)P DIVERGE on this operator (upwind wave system at cfl≈333 is
  far from SPD; measured 2010 its unconverged) — plain aggregation it is.
- **V(1,1) cycle, point-block-Jacobi smoother** at every level, dense
  bottom inverse (one matmul). Two-level-exact at factor 4 measured 88
  its; the recursive V-cycle keeps 103 of it at bottom size ≈ n/16.
  Heavier cycles trade iterations for fine-level applies (KTetra2: V(1,1)
  52 its, V(2,2) 32, V(1,0) 94), so V(1,1) stays the default until the
  SpMV itself gets cheaper.
- Coarse-level SpMVs ride the clustered-window dense operator
  (ops/window_spmv.py) — contiguous aggregation preserves the RCM
  bandwidth, so windows stay tight.

Reference parity: this finishes the PCSHELL program of
/root/reference/src/PCSHELLFft_3D.cxx:101-151 + ToDo.md:1 on the meshes the
reference actually benchmarks, where its intended cartesian intersection
matrix provably cannot work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.ops.csr import BSRMatrix
from circulantpreconditioner_tpu.ops.window_spmv import WindowedBlockOperator


@jax.tree_util.register_pytree_node_class
@dataclass
class _Level:
    """One multigrid level: operator apply, smoother blocks, transfer data."""

    A: Any              # callable pytree (Partial / WindowedBlockOperator.matvec_partial)
    Dinv: jax.Array     # (n, b, b) inverted point-blocks of A (smoother)
    cnt_inv: jax.Array  # (n_agg,) 1/|aggregate| for the mean restriction
    n: int              # block rows at this level
    b: int              # block size
    factor: int         # aggregation factor to the next level
    n_agg: int          # block rows at the next level
    A_fm: Any = None    # FIELD-MAJOR flat operator apply (grid PCs only)

    def tree_flatten(self):
        return ((self.A, self.Dinv, self.cnt_inv, self.A_fm),
                (self.n, self.b, self.factor, self.n_agg))

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, Dinv, cnt_inv, A_fm = children
        return cls(A, Dinv, cnt_inv, *aux, A_fm=A_fm)


def _smooth(L: _Level, omega, r):
    z = jnp.einsum("nij,nj->ni", L.Dinv, r.reshape(-1, L.b)).reshape(-1)
    return omega * z if omega != 1.0 else z


def _restrict(L: _Level, r):
    pad = L.n_agg * L.factor - L.n
    rb = r.reshape(-1, L.b)
    if pad:
        rb = jnp.pad(rb, ((0, pad), (0, 0)))
    s = rb.reshape(L.n_agg, L.factor, L.b).sum(axis=1)
    return (s * L.cnt_inv[:, None]).reshape(-1)


def _prolong(L: _Level, zc):
    zb = jnp.broadcast_to(zc.reshape(L.n_agg, 1, L.b),
                          (L.n_agg, L.factor, L.b))
    return zb.reshape(-1, L.b)[:L.n].reshape(-1)


# field-major (fm) variants: vectors are flat with x.reshape(b, n) — or, on
# a supercell _Level, x.reshape(factor·b, n_agg) — as the field view. Used
# by GridVCyclePC.apply_fm; valid on _Level only when n == factor·n_agg
# (the cells-per-site aggregation), which from_grid_model guarantees.


def _smooth_fm(L: _Level, omega, g):
    gk = g.reshape(L.factor, L.b, L.n_agg)
    DT = L.Dinv.reshape(L.n_agg, L.factor, L.b, L.b)
    z = jnp.einsum("nkij,kjn->kin", DT, gk).reshape(-1)
    return omega * z if omega != 1.0 else z


def _restrict_fm(L: _Level, g):
    return (g.reshape(L.factor, L.b, L.n_agg).sum(axis=0)
            * L.cnt_inv[None, :]).reshape(-1)


def _prolong_fm(L: _Level, zc):
    zb = jnp.broadcast_to(zc.reshape(1, L.b, L.n_agg),
                          (L.factor, L.b, L.n_agg))
    return zb.reshape(-1)


@jax.tree_util.register_pytree_node_class
class AggregationVCyclePC:
    """M⁻¹ r ≈ A⁻¹ r via one V(pre,post) cycle over Galerkin coarse levels.

    Built host-side from the assembled fine operator; apply is one jittable
    pipeline of reshapes, batched (b×b) einsums, windowed SpMVs and a dense
    bottom matmul — no gathers, no scans."""

    def __init__(self, levels, bot_inv, n_smooth=(1, 1), omega=1.0, b=None):
        self.levels = tuple(levels)
        self.bot_inv = bot_inv
        self.n_smooth = tuple(n_smooth)
        self.omega = float(omega)
        # block size for the bottom-level field-major relayout; needed when
        # the hierarchy has ZERO levels (whole mesh ≤ bottom_max)
        self.b = int(b) if b is not None else (levels[-1].b if levels else 1)

    def tree_flatten(self):
        return ((self.levels, self.bot_inv),
                (self.n_smooth, self.omega, self.b))

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, bot_inv = children
        return cls(levels, bot_inv, *aux)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_bsr(cls, D: BSRMatrix, A0_apply=None, shift: float = 1.0,
                 factor: int = 4, bottom_max: int = 1200,
                 n_smooth=(1, 1), omega: float = 1.0, dtype=jnp.float32,
                 max_levels: int = 10, window_G: int = 8):
        """Build from the assembled FV block operator D, preconditioning
        A = shift·I + D (the implicit FV system). `A0_apply` supplies the
        production fine-level matvec (windowed / varying-stencil); when None
        a windowed operator is built from D."""
        import scipy.sparse as sp

        b = D.block_size
        A0 = (shift * sp.identity(D.shape[0], format="csr")
              + D.to_csr(dtype).to_scipy().astype(np.float64)).tocsr()
        if A0_apply is None:
            W0 = WindowedBlockOperator.from_bsr(D, G=window_G, dtype=dtype)
            A0_apply = jax.tree_util.Partial(
                _shifted_apply, W0.matvec_partial(), jnp.asarray(shift, dtype))

        levels = []
        A_l = A0
        apply_l = A0_apply
        n_l = A0.shape[0] // b
        for _ in range(max_levels):
            if n_l <= bottom_max:
                break
            n_agg = -(-n_l // factor)
            agg = np.arange(n_l) // factor
            cnt = np.bincount(agg, minlength=n_agg).astype(np.float64)
            P_a = sp.csr_matrix((np.ones(n_l), (np.arange(n_l), agg)),
                                shape=(n_l, n_agg))
            R_a = sp.csr_matrix((1.0 / cnt[agg], (agg, np.arange(n_l))),
                                shape=(n_agg, n_l))
            eye_b = sp.identity(b, format="csr")
            P = sp.kron(P_a, eye_b).tocsr()
            R = sp.kron(R_a, eye_b).tocsr()
            levels.append(_Level(
                A=apply_l,
                Dinv=_block_diag_inv(A_l, b, dtype),
                cnt_inv=jnp.asarray(1.0 / cnt, dtype),
                n=n_l, b=b, factor=factor, n_agg=n_agg,
            ))
            A_l = (R @ A_l @ P).tocsr()
            n_l = n_agg
            W_l = _windowed_from_scipy_bsr(A_l, b, n_l, window_G, dtype)
            apply_l = W_l.matvec_partial()

        bot_inv = jnp.asarray(np.linalg.inv(A_l.toarray()), dtype)
        return cls(levels, bot_inv, n_smooth=n_smooth, omega=omega, b=b)

    # -- apply --------------------------------------------------------------

    def apply(self, r: jax.Array) -> jax.Array:
        return _vcycle(self.levels, self.bot_inv, self.n_smooth, self.omega,
                       0, r, bot_b=self.b)

    def apply_fm(self, g: jax.Array) -> jax.Array:
        """FIELD-MAJOR apply (flat g with g.reshape(b, n) — or, on a
        supercell fine level, g.reshape(cps·b, n_sites) — as the field
        view): zero relayouts end-to-end, for composition with the
        field-major steppers. Requires the levels to carry A_fm (grid
        hierarchies built by from_grid_model)."""
        return _vcycle(self.levels, self.bot_inv, self.n_smooth, self.omega,
                       0, g, fm=True, bot_b=self.b)

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)

    def apply_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(type(self).apply, self)

    def apply_fm_partial(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(type(self).apply_fm, self)

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1


def _vcycle(levels, bot_inv, n_smooth, omega, l, r, fm=False, bot_b=1):
    if l == len(levels):
        if fm:
            x = jnp.matmul(bot_inv, r.reshape(bot_b, -1).T.reshape(-1),
                           precision=jax.lax.Precision.HIGHEST)
            return x.reshape(-1, bot_b).T.reshape(-1)
        return jnp.matmul(bot_inv, r, precision=jax.lax.Precision.HIGHEST)
    L = levels[l]
    grid = isinstance(L, _GridLevel)
    if fm:
        smooth = _grid_smooth_fm if grid else _smooth_fm
        restrict = _grid_restrict_fm if grid else _restrict_fm
        prolong = _grid_prolong_fm if grid else _prolong_fm
        A = L.A_fm
    else:
        smooth = _grid_smooth if grid else _smooth
        restrict = _grid_restrict if grid else _restrict
        prolong = _grid_prolong if grid else _prolong
        A = L.A
    z = smooth(L, omega, r)
    for _ in range(n_smooth[0] - 1):
        z = z + smooth(L, omega, r - A(z))
    rc = restrict(L, r - A(z))
    z = z + prolong(L, _vcycle(levels, bot_inv, n_smooth, omega, l + 1, rc,
                               fm=fm, bot_b=bot_b))
    for _ in range(n_smooth[1]):
        z = z + smooth(L, omega, r - A(z))
    return z


def _shifted_apply(Dmv, shift, x):
    return shift * x + Dmv(x)


# ---------------------------------------------------------------------------
# Grid (geometric-Galerkin) V-cycle for recovered-grid meshes
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclass
class _GridLevel:
    """A multigrid level living on an (nx,ny,nz) site grid: transfers are
    2×2×2 box mean/broadcast — pure reshapes, no gathers — and the operator
    is the gather-free VaryingStencilOperator (7-point Galerkin)."""

    A: Any               # callable pytree
    Dinv: jax.Array      # (n_sites, b, b)
    cnt_inv: jax.Array   # (cz, cy, cx, 1) 1/|box| incl. boundary truncation
    shape_xyz: tuple     # fine grid (nx, ny, nz)
    cshape_xyz: tuple    # coarse grid (cx, cy, cz)
    b: int
    A_fm: Any = None     # field-major flat operator apply

    def tree_flatten(self):
        return ((self.A, self.Dinv, self.cnt_inv, self.A_fm),
                (self.shape_xyz, self.cshape_xyz, self.b))

    @classmethod
    def tree_unflatten(cls, aux, children):
        A, Dinv, cnt_inv, A_fm = children
        return cls(A, Dinv, cnt_inv, *aux, A_fm=A_fm)


def _grid_smooth(L: _GridLevel, omega, r):
    z = jnp.einsum("nij,nj->ni", L.Dinv, r.reshape(-1, L.b)).reshape(-1)
    return omega * z if omega != 1.0 else z


def _grid_restrict(L: _GridLevel, r):
    nx, ny, nz = L.shape_xyz
    cx, cy, cz = L.cshape_xyz
    g = r.reshape(nz, ny, nx, L.b)
    pads = ((0, 2 * cz - nz), (0, 2 * cy - ny), (0, 2 * cx - nx), (0, 0))
    if any(p[1] for p in pads):
        g = jnp.pad(g, pads)
    s = g.reshape(cz, 2, cy, 2, cx, 2, L.b).sum(axis=(1, 3, 5))
    return (s * L.cnt_inv).reshape(-1)


def _grid_prolong(L: _GridLevel, zc):
    nx, ny, nz = L.shape_xyz
    cx, cy, cz = L.cshape_xyz
    g = zc.reshape(cz, 1, cy, 1, cx, 1, L.b)
    g = jnp.broadcast_to(g, (cz, 2, cy, 2, cx, 2, L.b))
    return g.reshape(2 * cz, 2 * cy, 2 * cx, L.b)[:nz, :ny, :nx].reshape(-1)


def _grid_smooth_fm(L: _GridLevel, omega, g):
    z = jnp.einsum("nij,jn->in", L.Dinv, g.reshape(L.b, -1)).reshape(-1)
    return omega * z if omega != 1.0 else z


def _grid_restrict_fm(L: _GridLevel, g):
    nx, ny, nz = L.shape_xyz
    cx, cy, cz = L.cshape_xyz
    gg = g.reshape(L.b, nz, ny, nx)
    pads = ((0, 0), (0, 2 * cz - nz), (0, 2 * cy - ny), (0, 2 * cx - nx))
    if any(p[1] for p in pads):
        gg = jnp.pad(gg, pads)
    s = gg.reshape(L.b, cz, 2, cy, 2, cx, 2).sum(axis=(2, 4, 6))
    return (s * L.cnt_inv.reshape(1, cz, cy, cx)).reshape(-1)


def _grid_prolong_fm(L: _GridLevel, zc):
    nx, ny, nz = L.shape_xyz
    cx, cy, cz = L.cshape_xyz
    g = zc.reshape(L.b, cz, 1, cy, 1, cx, 1)
    g = jnp.broadcast_to(g, (L.b, cz, 2, cy, 2, cx, 2))
    return g.reshape(L.b, 2 * cz, 2 * cy, 2 * cx)[:, :nz, :ny, :nx].reshape(-1)


@jax.tree_util.register_pytree_node_class
class GridVCyclePC(AggregationVCyclePC):
    """Geometric-Galerkin multigrid V-cycle for meshes with RECOVERED grid
    topology (warped Kershaw hexahedra, hex-major supercell tet meshes):
    level 1 aggregates the `cells_per_site` cells of each grid site, deeper
    levels coarsen 2×2×2 site boxes. All coarse operators are exact Galerkin
    restrictions assembled host-side and applied as gather-free 7-point
    varying stencils, so the hierarchy costs ~nnz/8 per level in HBM (the
    clustered-window form of the same operators is ~15× nnz, too large to
    stage host→device at the 750k-cell ladder rung).

    Unlike the cartesian surrogate PCs (solvers/circulant_pc.py) this is
    warp-adaptive: the coarse operators inherit the warped coefficients, so
    it converges where dct2lm diverges (generated kershaw-TET meshes:
    dct2lm unconverged at 12³, this PC converges — round-5 measurement).

    The ω=0.8 smoother damping is LOAD-BEARING, not a tweak: undamped
    block-Jacobi smoothing amplifies high-frequency error on the upwind
    wave operator — kershaw-tet 16³ measures 195 its at ω=1.0 (and outright
    divergence with 2 smoothing steps) vs 42 at ω=0.8; the ω∈[0.6,0.9]
    plateau is flat (43/42/42/46), so 0.8 is safely mid-plateau. With the
    damping the grid cycle also MATCHES the wall-BC DCT projection PC on
    generated kershaw hexes (25 vs 27 its at 16³) at a fraction of the
    apply cost."""

    @classmethod
    def from_grid_model(cls, D: BSRMatrix, shape_xyz, cells_per_site: int = 1,
                        A0_apply=None, A0_apply_fm=None, shift: float = 1.0,
                        bottom_max: int = 600, n_smooth=(1, 1),
                        omega: float = 0.8, dtype=jnp.float32):
        """A0_apply / A0_apply_fm: production fine-level matvecs (cell-major
        flat / field-major flat). When None they are built from D's varying
        stencil; pass the model's own (e.g. the block-sparse supercell fm
        operator — the dense (cps·b)² cell-major form is 8× bigger)."""
        import scipy.sparse as sp

        from circulantpreconditioner_tpu.ops.stencil import VaryingStencilOperator

        b = D.block_size
        A0 = (shift * sp.identity(D.shape[0], format="csr")
              + D.to_csr(dtype).to_scipy().astype(np.float64)).tocsr()
        if A0_apply is None or A0_apply_fm is None:
            op0 = VaryingStencilOperator.from_bsr(D, shape_xyz,
                                                  cells_per_site=cells_per_site,
                                                  dtype=dtype)
            sh = jnp.asarray(shift, dtype)
            if A0_apply is None:
                A0_apply = jax.tree_util.Partial(
                    _shifted_apply,
                    jax.tree_util.Partial(VaryingStencilOperator.matvec, op0),
                    sh)
            if A0_apply_fm is None and op0.layout in ("flat",):
                A0_apply_fm = jax.tree_util.Partial(
                    _shifted_apply,
                    jax.tree_util.Partial(
                        VaryingStencilOperator.matvec_fm_flat, op0), sh)

        levels = []
        n0 = A0.shape[0] // b
        n_sites = int(np.prod(shape_xyz))
        cps = int(cells_per_site)
        A_l = A0
        if cps > 1:
            # level 0→1: aggregate the cps cells of each site (contiguous in
            # the hex-major numbering → reshape transfers via _Level)
            cnt = np.full(n_sites, cps, dtype=np.float64)
            levels.append(_Level(
                A=A0_apply, Dinv=_block_diag_inv(A_l, b, dtype),
                cnt_inv=jnp.asarray(1.0 / cnt, dtype),
                n=n0, b=b, factor=cps, n_agg=n_sites, A_fm=A0_apply_fm))
            A_l = _galerkin_chunk(A_l, b, n0, cps, n_sites)
        shape = tuple(int(v) for v in shape_xyz)
        first_grid = cps == 1
        while int(np.prod(shape)) > bottom_max:
            cshape = tuple(-(-s // 2) for s in shape)
            nx, ny, nz = shape
            cx, cy, cz = cshape
            # site → box flat index map (x-fastest)
            xi = np.arange(nx) // 2
            yi = np.arange(ny) // 2
            zi = np.arange(nz) // 2
            site = (xi[None, None, :] + cx * yi[None, :, None]
                    + cx * cy * zi[:, None, None]).reshape(-1)
            n_c = cx * cy * cz
            cnt = np.bincount(site, minlength=n_c).astype(np.float64)
            cnt_inv = jnp.asarray(
                (1.0 / cnt).reshape(cz, cy, cx, 1), dtype)
            if first_grid:
                # the first grid level IS the fine level: reuse the
                # production operators instead of duplicating the stencil
                A_cm, A_fm = A0_apply, A0_apply_fm
            else:
                op_l = _varying_from_scipy(A_l, b, shape, dtype)
                A_cm = jax.tree_util.Partial(type(op_l).matvec, op_l)
                A_fm = (jax.tree_util.Partial(type(op_l).matvec_fm_flat, op_l)
                        if op_l.layout == "flat" else None)
            levels.append(_GridLevel(
                A=A_cm, Dinv=_block_diag_inv(A_l, b, dtype), cnt_inv=cnt_inv,
                shape_xyz=shape, cshape_xyz=cshape, b=b, A_fm=A_fm))
            A_l = _galerkin_map(A_l, b, site, n_c)
            shape = cshape
            first_grid = False

        bot_inv = jnp.asarray(np.linalg.inv(A_l.toarray()), dtype)
        return cls(levels, bot_inv, n_smooth=n_smooth, omega=omega, b=b)


def _galerkin_chunk(A_csr, b, n, factor, n_agg):
    import scipy.sparse as sp

    agg = np.arange(n) // factor
    return _galerkin_map(A_csr, b, agg, n_agg)


def _galerkin_map(A_csr, b, agg, n_agg):
    """Galerkin R·A·P for an arbitrary aggregate map (piecewise-constant P,
    mean R), block size b."""
    import scipy.sparse as sp

    n = len(agg)
    cnt = np.bincount(agg, minlength=n_agg).astype(np.float64)
    P_a = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, n_agg))
    R_a = sp.csr_matrix((1.0 / cnt[agg], (agg, np.arange(n))), shape=(n_agg, n))
    eye_b = sp.identity(b, format="csr")
    P = sp.kron(P_a, eye_b).tocsr()
    R = sp.kron(R_a, eye_b).tocsr()
    return (R @ A_csr @ P).tocsr()


def _varying_from_scipy(A_csr, b, shape_xyz, dtype):
    from circulantpreconditioner_tpu.ops.stencil import VaryingStencilOperator

    Ab = A_csr.tobsr(blocksize=(b, b))
    brows = np.repeat(np.arange(A_csr.shape[0] // b), np.diff(Ab.indptr))
    return VaryingStencilOperator.from_blocks(brows, Ab.indices, Ab.data,
                                              shape_xyz, dtype=dtype)


def _block_diag_inv(A_csr, b: int, dtype) -> jax.Array:
    """(n, b, b) inverted diagonal blocks of a scipy CSR with b×b block
    structure."""
    coo = A_csr.tocoo()
    n = A_csr.shape[0] // b
    br, bc = coo.row // b, coo.col // b
    m = br == bc
    blocks = np.zeros((n, b, b))
    blocks[br[m], coo.row[m] % b, coo.col[m] % b] = coo.data[m]
    return jnp.asarray(np.linalg.inv(blocks), dtype)


def _windowed_from_scipy_bsr(A_csr, b: int, n_brows: int, G: int, dtype):
    """Clustered-window operator from a scipy CSR with b×b block structure."""
    Ab = A_csr.tobsr(blocksize=(b, b))
    brows = np.repeat(np.arange(n_brows), np.diff(Ab.indptr))
    return WindowedBlockOperator.from_block_coo(
        n_brows, brows, Ab.indices, Ab.data, G=G, dtype=dtype)
