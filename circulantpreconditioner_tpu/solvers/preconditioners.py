"""Preconditioners: identity, Jacobi, point-block Jacobi, ILU(0), circulant.

Parity with the reference's PC usage:
- PCNONE   (TransportEquation_SphericalExplosion_impl_mpi.cxx:33-35) → identity
- PCILU    (WaveSystem_SphericalExplosion_impl_seq.cxx:31-33)        → ILU(0)
  with level-scheduled sparse triangular solves on device
- PCBJACOBI(WaveSystem_SphericalExplosion_impl_mpi.cxx:32-34)        → per-
  partition ILU(0) (block_jacobi_ilu0) and point-block Jacobi (pbjacobi)
- the circulant FFT preconditioner (PCSHELLFft_3D.cxx, completed here) is
  provided by CirculantTransportOperator.as_preconditioner() and the
  projection-composed variant in solvers/circulant_pc.py.

All apply() paths are jittable closures over device arrays.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from circulantpreconditioner_tpu.ops.csr import BSRMatrix, CSRMatrix


def identity() -> Callable[[jax.Array], jax.Array]:
    return lambda r: r


def _diag_apply(dinv, r):
    return dinv * r


def jacobi(A: CSRMatrix) -> jax.tree_util.Partial:
    """Diagonal scaling M⁻¹ = diag(A)⁻¹ (pytree-callable: the scaling vector
    is a runtime parameter — see gmres.make_gmres)."""
    d = A.diagonal()
    dinv = jnp.where(jnp.abs(d) > 0, 1.0 / d, 1.0)
    return jax.tree_util.Partial(_diag_apply, dinv)


def _block_diag_apply(Dinv, r):
    b = Dinv.shape[-1]
    rb = r.reshape(-1, b)
    return jnp.einsum("nij,nj->ni", Dinv, rb).reshape(-1)


def pbjacobi(A: BSRMatrix, shift: float = 0.0) -> jax.tree_util.Partial:
    """Point-block Jacobi (PETSc PCPBJACOBI): invert the (b×b) diagonal
    blocks once; apply is a batched small matvec.
    shift=1.0 preconditions I + A (the implicit FV systems) without
    materializing the shifted matrix."""
    D = np.asarray(A.block_diagonal())  # (n_brows, b, b)
    if shift:
        D = D + shift * np.eye(A.block_size)[None, :, :]
    Dinv = jnp.asarray(np.linalg.inv(D), dtype=A.blocks.dtype)
    return jax.tree_util.Partial(_block_diag_apply, Dinv)


def _block_diag_apply_fm(DinvT, r):
    """DinvT (b, b, n): field-major point-block apply on a flat (b·n,)
    field-major vector — 16 full-lane multiply-add streams, no relayout."""
    b = DinvT.shape[0]
    g = r.reshape(b, -1)
    return jnp.einsum("ijn,jn->in", DinvT, g).reshape(-1)


def pbjacobi_fm(A: BSRMatrix, shift: float = 0.0) -> jax.tree_util.Partial:
    """pbjacobi for FIELD-MAJOR flat vectors (x.reshape(b, n) is the field
    view). The inverted diagonal blocks are stored (b, b, n) so the apply is
    16 lane-parallel streams instead of a batched (n,b,b)·(n,b) contraction
    with b=4 trailing lanes."""
    D = np.asarray(A.block_diagonal())
    if shift:
        D = D + shift * np.eye(A.block_size)[None, :, :]
    Dinv = np.linalg.inv(D)  # (n, b, b)
    DinvT = np.ascontiguousarray(Dinv.transpose(1, 2, 0))
    return jax.tree_util.Partial(
        _block_diag_apply_fm, jnp.asarray(DinvT, dtype=A.blocks.dtype))


def _cell_major_adapter_apply(apply_cm, eye_m, r):
    m = eye_m.shape[0]
    z = apply_cm(r.reshape(m, -1).T.reshape(-1))
    return z.reshape(-1, m).T.reshape(-1)


def cell_major_adapter(apply_cm, m: int) -> jax.tree_util.Partial:
    """Wrap a cell-major preconditioner apply for use on FIELD-MAJOR flat
    vectors: one (N,m)↔(m,N) relayout pair per apply. The m×m identity
    exists only to carry the static block size through the Partial pytree."""
    return jax.tree_util.Partial(_cell_major_adapter_apply, apply_cm,
                                 jnp.eye(int(m)))


def _additive_apply(appliers, r):
    out = appliers[0](r)
    for M in appliers[1:]:
        out = out + M(r)
    return out


def additive(*appliers: Callable[[jax.Array], jax.Array]) -> Callable[[jax.Array], jax.Array]:
    """Additive combination M⁻¹ = Σ Mᵢ⁻¹ (PETSc PCCOMPOSITE ADDITIVE).
    The standard cure for a rank-deficient coarse PC: adding a nonsingular
    smoother (e.g. pbjacobi) makes the composite usable as a right PC.
    Measured (kershaw 8³ wave, cfl=333, right-PC GMRES on true residual):
    plain 178 its, pbjacobi 139, multiplicative two-level 101,
    additive circulant+pbjacobi 85. If every applier is a tree_util.Partial,
    the composite is too (stays a runtime-parameter operator)."""
    if all(isinstance(M, jax.tree_util.Partial) for M in appliers):
        return jax.tree_util.Partial(_additive_apply, tuple(appliers))

    def apply(r: jax.Array) -> jax.Array:
        return _additive_apply(appliers, r)

    return apply


def _multiplicative_apply(A, coarse, smoother, r):
    z = coarse(r)
    return z + smoother(r - A(z))


def multiplicative(A: Callable, coarse: Callable, smoother: Callable) -> Callable:
    """Multiplicative two-level cycle: z = Mc r; z += Ms (r − A z)
    (PETSc PCCOMPOSITE MULTIPLICATIVE). One extra operator apply per PC
    apply, but measurably fewer Krylov iterations than the additive
    composite with the DCT coarse term (kershaw 8/16³ implicit wave,
    cfl=333, tol 1e-5: 10/27 its vs additive's 18/41). Partial-preserving
    like `additive`."""
    if all(isinstance(f, jax.tree_util.Partial) for f in (A, coarse, smoother)):
        return jax.tree_util.Partial(_multiplicative_apply, A, coarse, smoother)

    def apply(r: jax.Array) -> jax.Array:
        return _multiplicative_apply(A, coarse, smoother, r)

    return apply


# ---------------------------------------------------------------------------
# ILU(0)
# ---------------------------------------------------------------------------


def _ilu0_factor_host(indptr, indices, data):
    """In-place ILU(0) (IKJ variant) on host. Returns modified `data` where
    strictly-lower entries hold L (unit diagonal implied) and upper+diag hold U.
    Column indices within each row must be sorted (guaranteed by our CSR
    builders)."""
    n = len(indptr) - 1
    data = data.copy()
    # position of the diagonal in each row
    diag_pos = np.empty(n, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols = indices[s:e]
        d = np.searchsorted(cols, i)
        if d >= e - s or cols[d] != i:
            raise ValueError(f"ILU(0): missing diagonal in row {i}")
        diag_pos[i] = s + d
    # quick col->pos lookup per row via dict of dicts is slow; use searchsorted
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        for kk in range(s, int(diag_pos[i])):
            k = indices[kk]
            piv = data[diag_pos[k]]
            if piv == 0.0:
                piv = np.finfo(data.dtype).tiny
            lik = data[kk] / piv
            data[kk] = lik
            # subtract lik * U[k, j] for j in row i's pattern, j > k
            ks, ke = indptr[k], indptr[k + 1]
            cols_k = indices[ks:ke]
            # entries of row k with col > k
            start_k = np.searchsorted(cols_k, k) + 1
            for pk in range(ks + start_k, ke):
                j = indices[pk]
                # find j in row i
                pj = np.searchsorted(cols_i, j)
                if pj < e - s and cols_i[pj] == j:
                    data[s + pj] -= lik * data[pk]
    return data, diag_pos


def _level_schedule(indptr, indices, strict_lower: bool, n: int):
    """Level sets for a triangular solve: rows in the same level have no
    dependencies among themselves. Returns list of row-index arrays (in
    dependency order; reversed ordering handled by caller for upper)."""
    level = np.zeros(n, dtype=np.int64)
    if strict_lower:
        for i in range(n):
            lmax = 0
            for p in range(indptr[i], indptr[i + 1]):
                j = indices[p]
                if j < i and level[j] + 1 > lmax:
                    lmax = level[j] + 1
            level[i] = lmax
    else:
        for i in range(n - 1, -1, -1):
            lmax = 0
            for p in range(indptr[i], indptr[i + 1]):
                j = indices[p]
                if j > i and level[j] + 1 > lmax:
                    lmax = level[j] + 1
            level[i] = lmax
    nlev = int(level.max()) + 1 if n else 0
    return [np.nonzero(level == l)[0] for l in range(nlev)]


class ILU0Preconditioner:
    """ILU(0) with level-scheduled sparse triangular solves on device.

    Factorization is host-side preprocessing (like PETSc's PCSetUp); the
    apply is jittable — rows within a level are independent, so each level
    is one vectorized ELL-style dot. Two apply schedules:

    - "unrolled": one gather/scatter pair per level baked into the trace.
      Fastest for small level counts, but trace and compile time grow like
      nx+ny+nz on 3D meshes.
    - "scan": all levels padded to one uniform (R, K) table and swept by a
      single lax.scan — O(1) trace size regardless of mesh size (the
      big-mesh path; padding overhead is ~2-3x the factor's memory, rows
      are scattered into a sentinel slot).

    schedule="auto" picks unrolled below _SCAN_THRESHOLD levels.
    """

    _SCAN_THRESHOLD = 24

    def __init__(self, A: CSRMatrix, dtype=None, schedule: str = "auto"):
        from circulantpreconditioner_tpu.native import ilu0_factor, level_schedule

        indptr = np.asarray(A.indptr)
        indices = np.asarray(A.indices)
        data = np.asarray(A.data, dtype=np.float64)
        n = A.shape[0]
        out = ilu0_factor(indptr, indices, data)  # native C++ core if built
        if out is not None:
            f, diag_pos = out
        else:
            f, diag_pos = _ilu0_factor_host(indptr, indices, data)
        dtype = dtype or A.data.dtype

        rown = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

        def build_tri(strict_lower: bool):
            lev = level_schedule(indptr, indices, strict_lower, n)
            if lev is not None:
                nlev = int(lev.max()) + 1 if n else 0
                rows_levels = [np.nonzero(lev == l)[0] for l in range(nlev)]
            else:
                rows_levels = _level_schedule(indptr, indices, strict_lower, n)
            # vectorized global ELL pack of the strict triangle (the per-row
            # Python loops this replaces cost ~minutes at 131k rows — the
            # "factor" time the round-4 ILU bench recorded was 99% this)
            mask = (indices < rown) if strict_lower else (indices > rown)
            sel_rows = rown[mask]
            sel_cols = indices[mask]
            sel_vals = f[mask]
            deg = np.bincount(sel_rows, minlength=n).astype(np.int64)
            Kg = max(int(deg.max()) if n else 0, 1)
            offs = np.zeros(n, dtype=np.int64)
            np.cumsum(deg[:-1], out=offs[1:])
            pos = np.arange(len(sel_rows), dtype=np.int64) - offs[sel_rows]
            cols_g = np.zeros((n, Kg), dtype=np.int32)
            vals_g = np.zeros((n, Kg), dtype=np.float64)
            cols_g[sel_rows, pos] = sel_cols
            vals_g[sel_rows, pos] = sel_vals
            # stay NumPy here: one jnp.asarray per level would mean
            # hundreds of tiny host→device transfers; conversion happens
            # once per triangle below
            levels = []
            for rows in rows_levels:
                k = max(int(deg[rows].max()) if len(rows) else 0, 1)
                levels.append((rows.astype(np.int32), cols_g[rows, :k],
                               vals_g[rows, :k]))
            return levels

        lower_np = build_tri(True)
        upper_np = build_tri(False)
        self._dinv = jnp.asarray(1.0 / f[diag_pos], dtype=dtype)
        self.n_levels = (len(lower_np), len(upper_np))
        if schedule == "auto":
            schedule = ("scan" if max(self.n_levels) > self._SCAN_THRESHOLD
                        else "unrolled")
        if schedule not in ("unrolled", "scan"):
            raise ValueError(f"schedule must be auto|unrolled|scan, got {schedule}")
        self.schedule = schedule
        if schedule == "scan":
            # levels go to device only as the three stacked arrays
            self._lower_stack = _stack_levels(lower_np, n, dtype)
            self._upper_stack = _stack_levels(upper_np, n, dtype)
            self._lower_levels = self._upper_levels = None
        else:
            to_dev = lambda lv: [(jnp.asarray(r), jnp.asarray(c),
                                  jnp.asarray(v, dtype=dtype)) for r, c, v in lv]
            self._lower_levels = to_dev(lower_np)
            self._upper_levels = to_dev(upper_np)

    def apply(self, r: jax.Array) -> jax.Array:
        """x = U⁻¹ L⁻¹ r (unit-diagonal L)."""
        return self.apply_partial()(r)

    def apply_partial(self) -> jax.tree_util.Partial:
        """Pytree-callable apply (factor arrays as runtime parameters)."""
        if self.schedule == "scan":
            return jax.tree_util.Partial(
                _ilu_apply_scan, self._lower_stack, self._upper_stack, self._dinv)
        return jax.tree_util.Partial(
            _ilu_apply, tuple(self._lower_levels), tuple(self._upper_levels), self._dinv
        )

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)


def _stack_levels(levels, n: int, dtype=None, chunk: int = 8):
    """Pad per-level (rows, cols, vals) tables to one uniform
    (n_steps, chunk, R, K) stack for the chunked lax.scan. Padding rows
    scatter into a sentinel slot at index n (the working vector is extended
    by one); padding cols read slot 0 with zero vals, contributing nothing;
    whole padding LEVELS (to fill the last chunk) are all-sentinel no-ops."""
    R = max(lv[0].shape[0] for lv in levels)
    K = max(lv[1].shape[1] for lv in levels)
    nlev = len(levels)
    nlev_p = -(-nlev // chunk) * chunk
    rows = np.full((nlev_p, R), n, dtype=np.int32)
    cols = np.zeros((nlev_p, R, K), dtype=np.int32)
    vals = np.zeros((nlev_p, R, K), dtype=np.asarray(levels[0][2]).dtype)
    for l, (r_, c_, v_) in enumerate(levels):
        m, k = np.asarray(c_).shape
        rows[l, :m] = np.asarray(r_)
        cols[l, :m, :k] = np.asarray(c_)
        vals[l, :m, :k] = np.asarray(v_)
    rows = rows.reshape(nlev_p // chunk, chunk, R)
    cols = cols.reshape(nlev_p // chunk, chunk, R, K)
    vals = vals.reshape(nlev_p // chunk, chunk, R, K)
    return (jnp.asarray(rows), jnp.asarray(cols),
            jnp.asarray(vals, dtype=dtype) if dtype is not None else jnp.asarray(vals))


def _ilu_apply_scan(lower_stack, upper_stack, dinv, r):
    """Scan-scheduled x = U⁻¹ L⁻¹ r: one lax.scan per triangle over the
    uniform-padded level stacks — O(1) trace size in the level count.

    Levels are CHUNKED: each scan step processes the chunk of consecutive
    levels stacked on axis 1 of the (n_steps, C, R, K) tables with an
    unrolled inner sequence. An unchunked apply is scan-step-latency-bound
    (~380 level-steps at 32³); chunking divides the step count by C at identical total work because
    the per-level tables are already padded to a uniform (R, K)."""
    from jax import lax

    n = r.shape[0]
    zero = jnp.zeros((1,), r.dtype)
    rs = jnp.concatenate([r, zero])            # sentinel slot at index n

    def lower_body(y, chunk):
        rows, cols, vals = chunk               # (C, R), (C, R, K), (C, R, K)
        for c in range(rows.shape[0]):
            acc = jnp.sum(vals[c] * y[cols[c]], axis=1)
            y = y.at[rows[c]].set(rs[rows[c]] - acc)
        return y, None

    y, _ = lax.scan(lower_body, rs, lower_stack)
    ys = y
    dinv_s = jnp.concatenate([dinv, jnp.ones((1,), dinv.dtype)])

    def upper_body(x, chunk):
        rows, cols, vals = chunk
        for c in range(rows.shape[0]):
            acc = jnp.sum(vals[c] * x[cols[c]], axis=1)
            x = x.at[rows[c]].set((ys[rows[c]] - acc) * dinv_s[rows[c]])
        return x, None

    x, _ = lax.scan(upper_body, y, upper_stack)
    return x[:n]


def _ilu_apply(lower_levels, upper_levels, dinv, r):
    y = r
    for rows, cols, vals in lower_levels:
        acc = jnp.sum(vals * y[cols], axis=1)
        y = y.at[rows].set(r[rows] - acc)
    # level 0 of the upper schedule = rows with no dependencies (the
    # trailing rows) — process levels in the order they were built
    x = y
    for rows, cols, vals in upper_levels:
        acc = jnp.sum(vals * x[cols], axis=1)
        x = x.at[rows].set((y[rows] - acc) * dinv[rows])
    return x


def ilu0(A: CSRMatrix, schedule: str = "auto") -> ILU0Preconditioner:
    return ILU0Preconditioner(A, schedule=schedule)


def block_jacobi_ilu0(A: CSRMatrix, n_blocks: int) -> Callable[[jax.Array], jax.Array]:
    """PETSc PCBJACOBI analog: partition rows into `n_blocks` contiguous
    chunks, ILU(0) on each diagonal block, apply independently (the inter-
    block couplings are dropped — same convergence behavior as the
    reference's MPI BJACOBI with np = n_blocks)."""
    n = A.shape[0]
    bounds = np.linspace(0, n, n_blocks + 1).astype(np.int64)
    Asp = A.to_scipy()
    subs = []
    for k in range(n_blocks):
        s, e = int(bounds[k]), int(bounds[k + 1])
        sub = CSRMatrix.from_scipy(Asp[s:e, s:e].tocsr(), dtype=A.data.dtype)
        subs.append((s, e, ILU0Preconditioner(sub)))

    def apply(r: jax.Array) -> jax.Array:
        parts = [pc.apply(r[s:e]) for s, e, pc in subs]
        return jnp.concatenate(parts)

    return apply
