"""Circulant FFT preconditioner for UNSTRUCTURED meshes via cartesian projection.

This completes the piece the reference left unfinished: its PCSHELL
(src/PCSHELLFft_3D.cxx) declares an `intersectionMatrix` mapping the
unstructured mesh onto a cartesian grid (ToDo.md:12 — "never constructed"),
derives the grid size as n_d ≈ nbCells^(1/dim) and λ_d from the mesh bbox
(getFFTPrec3DContext, PCSHELLFft_3D.cxx:101-151), then applies
M⁻¹ r = solve_3D(project(r)). Here the projection matrices are actually
built, and the apply projects BACK to the unstructured cells (the reference
stops at the cartesian grid, which cannot be returned to GMRES on the
unstructured mesh — an unfinished detail we must fix for the PC to work):

    M⁻¹ = P_back · C⁻¹ · P,
    P  (cart ← cells):  volume-weighted average of the unstructured cells
        overlapping each cartesian cell (MEDCoupling-remapper "crude matrix"
        analog, approximated by regular subsampling points located in cells
        via a cKDTree on cell centroids + nearest-centroid assignment),
    P_back (cells ← cart): each unstructured cell samples the cartesian cell
        containing its centroid (piecewise-constant interpolation).

P and P_back are host-built once (sparse, CSR) and applied on device; the
full apply (project → FFT/DFT-matmul circulant solve → project back) is one jitted
pipeline usable as M in solvers/gmres.py.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh.core import Mesh
from circulantpreconditioner_tpu.ops.circulant import (
    BlockCirculantOperator,
    CirculantTransportOperator,
    transform_method,
)
from circulantpreconditioner_tpu.ops.csr import CSRMatrix
from circulantpreconditioner_tpu.ops.dft_matmul import (
    MatmulBlockCirculantSolver,
    MatmulCirculantSolver,
)


def _block_solver(n_xyz, offsets, blocks, dtype, method):
    """Periodic block-circulant solve on the cartesian grid n_xyz, by the
    transform `method` ("auto" = transform_method())."""
    shape_zyx = tuple(reversed(n_xyz))
    if (transform_method() if method == "auto" else method) == "matmul":
        return MatmulBlockCirculantSolver.from_stencil(shape_zyx, offsets, blocks, dtype)
    return BlockCirculantOperator.from_stencil(shape_zyx, offsets, blocks, dtype)


def derive_grid_context(mesh: Mesh, velocity, dt: float):
    """n_d = round(nbCells^(1/dim)) per axis and λ_d = a_d·dt/Δ_d from the
    mesh bounding box — getFFTPrec3DContext parity (PCSHELLFft_3D.cxx:122-148,
    with its ⌊cbrt⌋ replaced by rounding, which recovers exact n for perfect
    cubes instead of n-1 from floating-point floor).

    The reference's sizing heuristic is measured-optimal, not just parity:
    refining the surrogate grid past n ≈ nbCells^(1/dim) makes the PC WORSE
    (kershaw 16³ wave dct2lm: 27 its at 1×, 40 at 1.5×, divergence at 2× —
    round 4). Finer voxels turn the projection into a near-permutation of
    the warped mesh, amplifying the cartesian operator's geometric mismatch
    instead of averaging it out."""
    dim = mesh.dim
    n_side = int(round(mesh.n_cells ** (1.0 / dim)))
    n_xyz = (max(n_side, 2),) * dim
    bbox = mesh.bbox()
    spacing = [(bbox[d, 1] - bbox[d, 0]) / n_xyz[d] for d in range(dim)]
    a = np.asarray(velocity, dtype=np.float64)[:dim]
    lambdas_xyz = [a[d] * dt / spacing[d] for d in range(dim)]
    return n_xyz, tuple(spacing), tuple(lambdas_xyz), bbox


def _cell_volume_samples(mesh: Mesh, levels: int = 1):
    """Equal-sub-volume sample points per cell: (pts (S, n_cells, dim),
    weight-per-point = cell_volume / S).

    A tetrahedron splits at its centroid into 4 sub-tets of EXACTLY equal
    volume (each = face_i × dist(centroid, face_i)/3 with the centroid at
    quarter-height over every face); recursing `levels` times gives 4^levels
    equal-volume deposit points. Non-tet cells (hexes, Kershaw polyhedra)
    use their single centroid. This makes the projection weights a true
    volume-intersection approximation (the MEDCoupling getCrudeMatrix
    semantics the reference intended, ToDo.md:12) instead of point sampling."""
    dim = mesh.dim
    cv = getattr(mesh, "cell_vertices", None)
    C = mesh.cell_center[:, :dim]
    if dim != 3 or cv is None:
        return C[None, :, :]
    if isinstance(cv, np.ndarray):
        is_tet = (cv >= 0).sum(axis=1) == 4 if cv.ndim == 2 else None
        verts = cv
    else:
        sizes = np.array([len(c) for c in cv])
        is_tet = sizes == 4
        verts = np.full((mesh.n_cells, 4), -1, dtype=np.int64)
        for i, c in enumerate(cv):
            if len(c) == 4:
                verts[i] = list(c)
    if is_tet is None or not is_tet.any():
        return C[None, :, :]
    pts = getattr(mesh, "points", None)
    if pts is None:
        return C[None, :, :]

    tets = np.where(is_tet)[0]
    corners = pts[verts[tets][:, :4]][:, :, :dim]  # (nt, 4, dim)

    def split(tet_corners):
        # one level: 4 equal-volume sub-tets (replace vertex i by centroid)
        c = tet_corners.mean(axis=1, keepdims=True)  # (nt, 1, dim)
        subs = []
        for i in range(4):
            sc = tet_corners.copy()
            sc[:, i:i + 1, :] = c
            subs.append(sc)
        return np.stack(subs, axis=1)  # (nt, 4, 4, dim)

    cur = corners[:, None, :, :]  # (nt, 1, 4, dim)
    for _ in range(max(0, levels)):
        nt, s = cur.shape[0], cur.shape[1]
        cur = split(cur.reshape(nt * s, 4, cur.shape[-1]))
        cur = cur.reshape(nt, s * 4, 4, cur.shape[-1])
    S = cur.shape[1]
    tet_pts = cur.mean(axis=2)  # (nt, S, dim) sub-tet centroids

    out = np.repeat(C[None, :, :], S, axis=0).copy()  # (S, n_cells, dim)
    out[:, tets, :] = tet_pts.transpose(1, 0, 2)
    return out


def build_projection_matrices(
    mesh: Mesh, n_xyz, bbox, samples_per_axis: int = 3, dtype=jnp.float32,
    method: str = "sample",
) -> tuple[CSRMatrix, CSRMatrix]:
    """(P cart←cells, P_back cells←cart).

    method="sample" (default): each voxel averages the nearest cells of
    samples_per_axis^dim regular points inside it — collocation of the
    residual field at voxel centers. P_back row c samples the voxel
    containing centroid(c).

    method="volume": CONSERVATIVE volume deposit — every mesh cell
    distributes its volume over equal-sub-volume sample points
    (_cell_volume_samples; 4 per tet, centroid otherwise); each point
    deposits cell_volume/S into its containing voxel, and P rows are
    normalized by the deposited mass. P[g,c] then approximates
    |cell_c ∩ voxel_g| / Σ_c |cell_c ∩ voxel_g| — the MEDCoupling
    volume-intersection ("crude matrix") weights the reference intended
    (PCSHELLFft_3D.cxx:101-151, ToDo.md:12). Voxels no cell deposits into
    fall back to their nearest cell centroid.

    MEASURED NEGATIVE RESULT (round 4; Kershaw n³ implicit wave, dct2lm
    GMRES iterations, cfl=1e3/3, tol 1e-5): sampling 10/27/49 at 8/16/24³
    vs volume deposits 10/47/186; pairing the volume P with its normalized
    adjoint as P_back (the "consistent" projection pair) stalls outright
    (>300 its from 16³ up). Interpretation: the coarse solve needs P to
    collocate POINT VALUES of the residual at voxel centers — a voxel
    dominated by one large warped cell should see that cell's value, not a
    volume-weighted blend of every sliver touching it. The
    getCrudeMatrix-semantics weights are therefore implemented and kept
    available, but collocation sampling stays the default because it
    measures strictly better on every tested mesh.
    """
    from scipy.spatial import cKDTree

    dim = mesh.dim
    n_xyz = tuple(int(v) for v in n_xyz)
    h = np.array([(bbox[d, 1] - bbox[d, 0]) / n_xyz[d] for d in range(dim)])
    lo = bbox[:, 0]
    n_cart = int(np.prod(n_xyz))

    def voxel_of(pts):
        idx = np.clip(((pts - lo[:dim]) / h).astype(np.int64), 0,
                      np.asarray(n_xyz) - 1)
        flat = np.zeros(len(pts), dtype=np.int64)
        stride = 1
        for d in range(dim):
            flat += idx[:, d] * stride
            stride *= n_xyz[d]
        return flat

    # cartesian cell centers, x-fastest flattening (z,y,x C-order)
    axes = [lo[d] + (np.arange(n_xyz[d]) + 0.5) * h[d] for d in range(dim)]
    grids = np.meshgrid(*reversed(axes), indexing="ij")
    cart_centers = np.stack([g.reshape(-1) for g in reversed(grids)], axis=1)

    if method == "volume":
        samples = _cell_volume_samples(mesh)  # (S, n_cells, dim)
        S = samples.shape[0]
        w = np.repeat(mesh.cell_volume[None, :] / S, S, axis=0).reshape(-1)
        rows = voxel_of(samples.reshape(-1, dim))
        cols = np.tile(np.arange(mesh.n_cells), S)
        # rows with no deposit: nearest cell centroid keeps them defined
        mass = np.zeros(n_cart)
        np.add.at(mass, rows, w)
        empty = np.where(mass == 0)[0]
        if empty.size:
            tree = cKDTree(mesh.cell_center[:, :dim])
            _, owner = tree.query(cart_centers[empty])
            rows = np.concatenate([rows, empty])
            cols = np.concatenate([cols, owner])
            w = np.concatenate([w, np.ones(empty.size)])
            mass[empty] = 1.0
        vals = w / mass[rows]
        P = CSRMatrix.from_coo(n_cart, mesh.n_cells, rows, cols, vals,
                               dtype=dtype)
    else:
        tree = cKDTree(mesh.cell_center[:, :dim])
        s = samples_per_axis
        offs_1d = [((np.arange(s) + 0.5) / s - 0.5) * h[d] for d in range(dim)]
        offs = np.meshgrid(*reversed(offs_1d), indexing="ij")
        offsets = np.stack([o.reshape(-1) for o in reversed(offs)], axis=1)

        pts = (cart_centers[:, None, :] + offsets[None, :, :]).reshape(-1, dim)
        _, owner = tree.query(pts)
        owner = owner.reshape(n_cart, -1)
        rows = np.repeat(np.arange(n_cart), owner.shape[1])
        cols = owner.reshape(-1)
        vals = np.full(rows.shape[0], 1.0 / owner.shape[1])
        P = CSRMatrix.from_coo(n_cart, mesh.n_cells, rows, cols, vals,
                               dtype=dtype)

    # P_back: cell centroid → containing cartesian cell index
    flat = voxel_of(mesh.cell_center[:, :dim])
    rows_b = np.arange(mesh.n_cells)
    P_back = CSRMatrix.from_coo(
        mesh.n_cells, n_cart, rows_b, flat, np.ones(mesh.n_cells), dtype=dtype
    )
    return P, P_back


def _identity_projection_applies(mesh: Mesh, n_xyz) -> bool:
    """True when the derived surrogate grid IS the mesh's recovered grid:
    `topology_shape == n_xyz` with one cell per site. Cells of a recovered
    grid are numbered x-fastest lexicographically (mesh/topology.py:129-147),
    exactly the projection's voxel flattening — so the geometric sampling
    matrices WOULD collapse to the identity.

    MEASURED NEGATIVE RESULT (round 5): identity projection DIVERGES on
    kershaw 16³ (dct2lm: 1000 its unconverged vs 27 for sampling; kershaw 8³
    both 10). The sampling's apparent "mis-sampling" under warp — voxel-edge
    sample points catching neighbouring cells — is load-bearing local
    averaging; removing it makes the projection the near-permutation limit
    round 4 already measured to be harmful (finer surrogate grids: 27/40/
    divergence at 1×/1.5×/2×). Identity therefore stays OPT-IN
    (projection="identity"), never auto-selected."""
    ts = getattr(mesh, "topology_shape", None)
    cps = int(getattr(mesh, "cells_per_site", 1) or 1)
    return ts is not None and tuple(ts) == tuple(n_xyz) and cps == 1


def _block_identity_apply(op, r):
    return op.solve(r)


def _scalar_identity_apply(solver, r):
    return solver.solve(r.reshape(solver.shape_zyx)).reshape(-1)


class BlockCirculantProjectionPC:
    """Block-circulant projection PC for the WAVE system on unstructured
    meshes: M⁻¹ = P_back ⊗ I_{dim+1} · C_blk⁻¹ · P ⊗ I_{dim+1}, where C_blk
    is the periodic cartesian wave operator (ops/assembly.wave_block_stencil)
    pre-inverted in frequency space. This is the 'GMRES + block-circulant PC
    on unstructured 3DTetrahedra/3DKershaw meshes' capability the reference
    names but never built (BASELINE.json configs; PCSHELLFft_3D.cxx is
    scalar-only and unfinished). Measured on kershaw 8³, cfl=333: plain
    GMRES 178 its → 93 its with this PC (gap grows with stiffness).

    Note: the cartesian operator is periodic while the FV operator has wall
    BCs — the boundary mismatch bounds the speedup. DCTBlockProjectionPC
    below removes it (exact wall-BC coarse solve via DCT-II/DST-II) and
    measures strictly fewer iterations at every Kershaw size
    (GMRES iterations 18/44/60 vs 40/62/80 at 8³/16³/24³).
    """

    def __init__(self, mesh: Mesh, dt: float, c0: float, dtype=jnp.float32,
                 samples_per_axis: int = 3, method: str = "auto",
                 projection: str = "auto"):
        from circulantpreconditioner_tpu.ops.assembly import wave_block_stencil

        n_xyz, spacing, _, bbox = derive_grid_context(mesh, [0.0] * mesh.dim, dt)
        self.n_xyz = n_xyz
        self.nb = mesh.dim + 1
        offsets, blocks = wave_block_stencil(mesh.dim, dt, c0, spacing)
        self.op = _block_solver(n_xyz, offsets, blocks, dtype, method)
        self._set_projection(mesh, n_xyz, bbox, samples_per_axis, dtype,
                             projection, _block_proj_apply,
                             _block_identity_apply)

    def _set_projection(self, mesh, n_xyz, bbox, samples_per_axis, dtype,
                        projection, proj_apply, ident_apply):
        """Shared tail of the block-PC constructors. projection="identity"
        (OPT-IN; see _identity_projection_applies for why never auto) maps
        recovered-grid cells 1:1 to voxels; default is geometric sampling."""
        if projection == "identity" and _identity_projection_applies(mesh, n_xyz):
            self.P = self.P_back = None
            self.projection = "identity"
            self.apply = jax.tree_util.Partial(ident_apply, self.op)
        else:
            self.P, self.P_back = build_projection_matrices(
                mesh, n_xyz, bbox, samples_per_axis, dtype,
                method=projection if projection in ("sample", "volume") else "sample",
            )
            Pw = _try_window(self.P)
            Pbw = _try_window(self.P_back)
            if Pw is not None and Pbw is not None:
                # clustered-window applies: a row gather + batched GEMV
                # instead of the CSR per-element gather
                self.projection = "sample-window"
                self.apply = jax.tree_util.Partial(
                    _block_proj_apply_win, Pw, self.op, Pbw)
            else:
                self.projection = "sample"
                # pytree-callable (runtime-parameter) apply — see gmres.make_gmres
                self.apply = jax.tree_util.Partial(proj_apply, self.P, self.op,
                                                   self.P_back)

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)


def _block_proj_apply(P, op, P_back, r):
    nb = op.m  # static pytree aux
    rc = r.reshape(-1, nb)
    r_cart = P.matvec(rc)  # (n_cart, nb)
    x_cart = op.solve(r_cart.reshape(-1))
    return P_back.matvec(x_cart.reshape(-1, nb)).reshape(-1)


def _block_proj_apply_win(Pw, op, Pbw, r):
    """_block_proj_apply with the projections as clustered-window operators
    (row gather + batched GEMV over the nb residual components)."""
    nb = op.m
    rc = r.reshape(-1, nb)
    r_cart = Pw.matvec_multi(rc)
    x_cart = op.solve(r_cart.reshape(-1))
    return Pbw.matvec_multi(x_cart.reshape(-1, nb)).reshape(-1)


def _try_window(P: CSRMatrix, max_bytes: int = 256 * 2**20):
    """Clustered-window form of a projection CSR, or None when the window
    padding would exceed `max_bytes` (scattered RCM-vs-raster orderings can
    blow the per-cluster unions up; recovered-grid meshes measure ~4 MB at
    32³)."""
    from circulantpreconditioner_tpu.ops.window_spmv import WindowedBlockOperator

    try:
        W = WindowedBlockOperator.from_csr(P, G=8, unit=8)
    except Exception:
        return None
    return W if W.window_bytes <= max_bytes else None


class DCTBlockProjectionPC:
    """Wall-BC (reflective) block projection PC for the WAVE system — the
    "DCT variant" upgrade of BlockCirculantProjectionPC: same projection
    matrices, but the cartesian operator is the WALL-boundary wave operator,
    inverted EXACTLY by mixed DCT-II/DST-II transforms
    (ops/dct_wave.DCTBlockWaveSolver). This removes the periodic-vs-wall
    boundary mismatch that bounds the periodic PC's effectiveness — the FV
    operator being preconditioned has wall mirrors
    (/root/reference/src/WaveSystem.cxx:150-157)."""

    def __init__(self, mesh: Mesh, dt: float, c0: float, dtype=jnp.float32,
                 samples_per_axis: int = 3, precision: str = "highest",
                 projection: str = "auto"):
        from circulantpreconditioner_tpu.ops.dct_wave import DCTBlockWaveSolver

        n_xyz, spacing, _, bbox = derive_grid_context(mesh, [0.0] * mesh.dim, dt)
        self.n_xyz = n_xyz
        self.nb = mesh.dim + 1
        self.op = DCTBlockWaveSolver.create(
            tuple(reversed(n_xyz)), mesh.dim, dt, c0, spacing, dtype, precision
        )
        BlockCirculantProjectionPC._set_projection(
            self, mesh, n_xyz, bbox, samples_per_axis, dtype, projection,
            _block_proj_apply, _block_identity_apply)

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)


class CirculantProjectionPC:
    """M⁻¹ = P_back · C⁻¹ · P for GMRES on unstructured FV operators."""

    def __init__(self, mesh: Mesh, velocity, dt: float, dtype=jnp.float32,
                 samples_per_axis: int = 3, method: str = "auto",
                 projection: str = "auto"):
        n_xyz, spacing, lambdas_xyz, bbox = derive_grid_context(mesh, velocity, dt)
        self.n_xyz = n_xyz
        shape_zyx = tuple(reversed(n_xyz))
        lambdas_zyx = tuple(reversed(lambdas_xyz))
        op = CirculantTransportOperator.create(shape_zyx, lambdas_zyx, dtype)
        self.op = op
        if (transform_method() if method == "auto" else method) == "matmul":
            self.solver = MatmulCirculantSolver.from_operator(op)
        else:
            self.solver = op
        if projection == "identity" and _identity_projection_applies(mesh, n_xyz):
            self.P = self.P_back = None
            self.projection = "identity"
            self.apply = jax.tree_util.Partial(_scalar_identity_apply, self.solver)
        else:
            self.P, self.P_back = build_projection_matrices(
                mesh, n_xyz, bbox, samples_per_axis, dtype
            )
            Pw = _try_window(self.P)
            Pbw = _try_window(self.P_back)
            if Pw is not None and Pbw is not None:
                self.projection = "sample-window"
                self.apply = jax.tree_util.Partial(
                    _scalar_proj_apply_win, Pw, self.solver, Pbw)
            else:
                self.projection = "sample"
                self.apply = jax.tree_util.Partial(
                    _scalar_proj_apply, self.P, self.solver, self.P_back
                )

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)


def _scalar_proj_apply(P, solver, P_back, r):
    r_cart = P.matvec(r)
    x_cart = solver.solve(r_cart.reshape(solver.shape_zyx)).reshape(-1)
    return P_back.matvec(x_cart)


def _scalar_proj_apply_win(Pw, solver, Pbw, r):
    r_cart = Pw.matvec(r)
    x_cart = solver.solve(r_cart.reshape(solver.shape_zyx)).reshape(-1)
    return Pbw.matvec(x_cart)


class DiffusionProjectionPC:
    """Circulant projection PC for the DIFFUSION equation on unstructured
    meshes — the FFTPrecDiffusionContext the reference planned (reference
    ToDo.md:5-6): project residual to the derived cartesian grid, solve
    (I + dt·ν·L_h)⁻¹ in frequency space, project back."""

    def __init__(self, mesh: Mesh, dt: float, nu: float, dtype=jnp.float32,
                 samples_per_axis: int = 3, method: str = "auto",
                 projection: str = "auto"):
        from circulantpreconditioner_tpu.ops.assembly import diffusion_stencil

        n_xyz, spacing, _, bbox = derive_grid_context(mesh, [0.0] * mesh.dim, dt)
        self.n_xyz = n_xyz
        offsets, blocks = diffusion_stencil(mesh.dim, dt, nu, spacing)
        blocks = blocks.copy()
        blocks[0] += 1.0  # symbol of I + D
        self.op = _block_solver(n_xyz, offsets, blocks, dtype, method)
        BlockCirculantProjectionPC._set_projection(
            self, mesh, n_xyz, bbox, samples_per_axis, dtype, projection,
            _block_proj_apply, _block_identity_apply)

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)
