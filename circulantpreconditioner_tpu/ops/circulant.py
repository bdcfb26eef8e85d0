"""Circulant / block-circulant FFT direct solver — the framework's core.

Capability parity with the reference's FFT solver stack
(`/root/reference/src/FftLinearSolver_3D.c`, validated there by the SciPy
oracles `/root/reference/tests/FFTDirectSolver/testFftSolver_{1,2,3}D.py`):

The implicit upwind transport operator on a periodic uniform grid is the
block-circulant matrix

    C = I + λx (I_{nz·ny} ⊗ C1_{nx}) + λy (I_{nz} ⊗ C1_{ny} ⊗ I_{nx})
          + λz (C1_{nz} ⊗ I_{ny·nx}),       λd = a_d · dt / Δ_d,

where C1_n is the circulant matrix with first column [1, -1, 0, …]
(reference `build_transport_col`, FftLinearSolver_3D.c:80-90). The 3D DFT
diagonalizes C; its eigenvalues are the separable tensor sum

    Λ[z, y, x] = 1 + λx·ĉ_nx[x] + λy·ĉ_ny[y] + λz·ĉ_nz[z],
    ĉ_n[k] = 1 - exp(-2πik/n)

(reference `build_diag_mat_vec_3D`, FftLinearSolver_3D.c:136-164, which tiles
three 1D FFTs with Kronecker products; here it is a closed-form broadcast —
no FFTs and no communication are needed to build Λ, each shard can compute
its slice with iota math).

The solve is x = IFFT( FFT(b) / Λ ). For real b we use rfftn/irfftn, which
replaces the entire packed-real-format machinery of the reference
(`VecPointwiseDivideForRealFFT`, FftLinearSolver_3D.c:7-78, including its
cross-rank complex-pair splitting) with a single XLA op pair.

Design notes (fixing known reference defects — see SURVEY.md §3.3):
- the spectrum Λ is built once and cached on device; the reference rebuilt
  its 1D FFT plans and Diag every timestep and destroyed the cached 3D plan
  (FftLinearSolver_3D.c:213),
- the whole FFT → divide → IFFT pipeline is one jitted function so XLA fuses
  the elementwise divide with the FFT shuffles,
- 1D/2D are the same code path with singleton axes (reference pads n=1,
  FftLinearSolver_3D.c:283-301).

`BlockCirculantOperator` generalises to (m×m)-block circulant operators (the
periodic wave system, m = dim+1) by assembling the per-frequency symbol
Λ̂(k) ∈ C^{m×m} and batch-inverting it once; each solve is then
FFT → batched (m×m)·m complex matvec → IFFT.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


def transform_method() -> str:
    """The transform the periodic direct solvers and circulant PCs use by
    default: "fft" (jnp.fft; cuFFT on a GPU) or "matmul" (ops/dft_matmul.py,
    every DFT as a dense GEMM).

    "fft" on every backend. Measured on an H100 80GB HBM3 at a 400 W power
    limit, one solve, µs, fft vs matmul at full float32 ("highest"):
    100³ a=(1,0,0) 58.0 vs 165.2, 100³ a=(1,0.5,0.25) 64.3 vs 161.3,
    256³ 535.4 vs 2838.0 and 534.2 vs 2859.8; the wave block solve at 64³
    101.7 vs 187.5. The TF32 tier ("high") is faster than "highest" but
    still slower than the FFT, and its residual is 5-30× larger."""
    return "fft"


def _complex_dtype(real_dtype) -> jnp.dtype:
    return jnp.complex128 if jnp.dtype(real_dtype) == jnp.float64 else jnp.complex64


# ---------------------------------------------------------------------------
# Host-side (NumPy) spectrum builders.
#
# Operator pytrees store spectra as (re, im) real pairs, built on host once
# at setup, and reassemble the complex value with lax.complex inside the
# jitted solve.
# ---------------------------------------------------------------------------


def np_transport_spectrum(n: int) -> np.ndarray:
    if n == 1:
        return np.ones((1,), dtype=np.complex128)
    k = np.arange(n)
    return 1.0 - np.exp(-2j * np.pi * k / n)


def np_eigenvalue_diagonal(
    shape_zyx: Sequence[int], lambdas_zyx: Sequence[float], rfft: bool = False
) -> np.ndarray:
    ndim = len(shape_zyx)
    out_shape = list(shape_zyx)
    if rfft:
        out_shape[-1] = shape_zyx[-1] // 2 + 1
    lam = np.ones(tuple(out_shape), dtype=np.complex128)
    for ax, (n, l) in enumerate(zip(shape_zyx, lambdas_zyx)):
        spec = np_transport_spectrum(n)
        if rfft and ax == ndim - 1:
            spec = spec[: n // 2 + 1]
        bshape = [1] * ndim
        bshape[ax] = spec.shape[0]
        lam = lam + l * spec.reshape(bshape)
    return lam


def transport_column(n: int, dtype=jnp.float32) -> jax.Array:
    """First column [1, -1, 0, …] of the 1D upwind circulant C1_n.

    Reference: build_transport_col, FftLinearSolver_3D.c:80-90.
    """
    col = jnp.zeros((n,), dtype=dtype)
    col = col.at[0].set(1.0)
    if n > 1:
        col = col.at[1].set(-1.0)
    return col


def transport_spectrum(n: int, dtype=jnp.float32) -> jax.Array:
    """DFT of the transport column: ĉ_n[k] = 1 - exp(-2πik/n), closed form.

    Equals fft(transport_column(n)); for n == 1 the circulant degenerates to
    [1] whose spectrum is ĉ = 0 is wrong — fft([1]) = [1]; but the reference
    pads absent axes with n=1 AND λ=0, so the value never matters. We still
    return the exact DFT.
    """
    cdtype = _complex_dtype(dtype)
    if n == 1:
        return jnp.ones((1,), dtype=cdtype)
    k = jnp.arange(n)
    return (1.0 - jnp.exp(-2j * jnp.pi * k / n)).astype(cdtype)


def eigenvalue_diagonal(
    shape_zyx: Sequence[int],
    lambdas_zyx: Sequence[float],
    dtype=jnp.float32,
    rfft: bool = False,
) -> jax.Array:
    """Separable eigenvalue field Λ of the implicit transport operator.

    `shape_zyx` orders axes as the array layout (…, y, x) with x fastest —
    the same C-order flattening the reference uses (testFftSolver_3D.py:35:
    Diag = 1 + λx·tile(ĉx, ny·nz) + λy·repeat(tile(ĉy,nz), nx)
             + λz·repeat(ĉz, nx·ny)).

    With rfft=True the last axis is truncated to n//2+1 to match rfftn.
    """
    ndim = len(shape_zyx)
    assert ndim == len(lambdas_zyx)
    cdtype = _complex_dtype(dtype)
    out_shape = list(shape_zyx)
    if rfft:
        out_shape[-1] = shape_zyx[-1] // 2 + 1
    lam = jnp.ones(tuple(out_shape), dtype=cdtype)
    for ax, (n, l) in enumerate(zip(shape_zyx, lambdas_zyx)):
        spec = transport_spectrum(n, dtype)
        if rfft and ax == ndim - 1:
            spec = spec[: n // 2 + 1]
        bshape = [1] * ndim
        bshape[ax] = spec.shape[0]
        lam = lam + jnp.asarray(l, dtype=cdtype) * spec.reshape(bshape)
    return lam


def stencil_symbol(
    shape_zyx: Sequence[int],
    offsets: Sequence[Sequence[int]],
    coeffs: Sequence[float] | np.ndarray,
    dtype=jnp.float32,
) -> jax.Array:
    """DFT symbol of a scalar periodic stencil operator.

    The operator A with (A u)[j] = Σ_o c_o · u[j + o] (indices mod n, offsets
    in zyx axis order) is circulant; its eigenvalue at frequency k is
    Λ̂(k) = Σ_o c_o · exp(+2πi Σ_d k_d o_d / n_d).

    Used to cross-validate `eigenvalue_diagonal` (offset -1 on an axis — the
    upwind neighbour u[j-1] — contributes exp(-2πik/n)) and to build symbols
    for arbitrary periodic FV stencils.
    """
    cdtype = _complex_dtype(dtype)
    ndim = len(shape_zyx)
    lam = jnp.zeros(shape_zyx, dtype=cdtype)
    for off, c in zip(offsets, coeffs):
        phase = jnp.zeros(shape_zyx, dtype=cdtype)
        for ax in range(ndim):
            if off[ax] == 0:
                continue
            n = shape_zyx[ax]
            k = jnp.arange(n)
            bshape = [1] * ndim
            bshape[ax] = n
            phase = phase + (2j * jnp.pi * off[ax] * k / n).reshape(bshape).astype(cdtype)
        lam = lam + jnp.asarray(c, dtype=cdtype) * jnp.exp(phase)
    return lam


def _solve_rfft(b: jax.Array, lam_r: jax.Array, shape_zyx: tuple[int, ...]) -> jax.Array:
    b_hat = jnp.fft.rfftn(b)
    x_hat = b_hat / lam_r
    return jnp.fft.irfftn(x_hat, s=shape_zyx)


def _solve_cfft(b: jax.Array, lam: jax.Array) -> jax.Array:
    b_hat = jnp.fft.fftn(b)
    x_hat = b_hat / lam
    return jnp.fft.ifftn(x_hat)


@jax.tree_util.register_pytree_node_class
@dataclass
class CirculantTransportOperator:
    """Device-cached circulant solver for the implicit upwind transport operator.

    Parity target: `Fft3DTransportSolver` / `PetscFft3DTransportSolver` and
    `struct StructuredTransportContext` (FftLinearSolver_3D.c:266-312, .h:7-43)
    — but with the spectrum built once, cached on device, and the whole
    solve jitted (the reference's per-step plan rebuild is a known defect,
    SURVEY.md §3.3).

    Axis order of all fields is zyx (x fastest), matching the reference's
    flattening. Use `from_transport` with physical xyz tuples.
    """

    shape_zyx: tuple[int, ...]
    lambdas_zyx: tuple[float, ...]
    # Spectra stored as (re, im) real pairs (see the spectrum builders above).
    lam_rfft_re: jax.Array
    lam_rfft_im: jax.Array
    lam_full_re: jax.Array
    lam_full_im: jax.Array

    # --- pytree plumbing (static shape/λ metadata, device-resident spectra) ---
    def tree_flatten(self):
        return (
            (self.lam_rfft_re, self.lam_rfft_im, self.lam_full_re, self.lam_full_im),
            (self.shape_zyx, self.lambdas_zyx),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape_zyx, lambdas_zyx = aux
        return cls(shape_zyx, lambdas_zyx, *children)

    @property
    def lam_rfft(self) -> jax.Array:
        return jax.lax.complex(self.lam_rfft_re, self.lam_rfft_im)

    @property
    def lam_full(self) -> jax.Array:
        return jax.lax.complex(self.lam_full_re, self.lam_full_im)

    # --- constructors ---
    @classmethod
    def create(cls, shape_zyx: Sequence[int], lambdas_zyx: Sequence[float], dtype=jnp.float32):
        shape_zyx = tuple(int(n) for n in shape_zyx)
        lambdas_zyx = tuple(float(l) for l in lambdas_zyx)
        lam_r = np_eigenvalue_diagonal(shape_zyx, lambdas_zyx, rfft=True)
        lam_f = np_eigenvalue_diagonal(shape_zyx, lambdas_zyx, rfft=False)
        return cls(
            shape_zyx,
            lambdas_zyx,
            jnp.asarray(lam_r.real, dtype=dtype),
            jnp.asarray(lam_r.imag, dtype=dtype),
            jnp.asarray(lam_f.real, dtype=dtype),
            jnp.asarray(lam_f.imag, dtype=dtype),
        )

    @classmethod
    def from_transport(
        cls,
        n_xyz: Sequence[int],
        velocity_xyz: Sequence[float],
        dt: float,
        spacing_xyz: Sequence[float],
        dtype=jnp.float32,
    ):
        """λ_d = a_d · dt / Δ_d (reference Fft3DTransportSolver,
        FftLinearSolver_3D.c:266-281); tuples given in physical (x, y, z)
        order, any length 1..3."""
        lambdas_xyz = [a * dt / h for a, h in zip(velocity_xyz, spacing_xyz)]
        return cls.create(tuple(reversed(tuple(n_xyz))), tuple(reversed(lambdas_xyz)), dtype)

    @property
    def ndim(self) -> int:
        return len(self.shape_zyx)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape_zyx))

    def _as_grid(self, b: jax.Array) -> tuple[jax.Array, bool]:
        if b.ndim == 1:
            return b.reshape(self.shape_zyx), True
        return b, False

    # --- the 3-op hot kernel: FFT → divide → IFFT (reference solve_3D,
    # FftLinearSolver_3D.c:166-190) ---
    @jax.jit
    def solve(self, b: jax.Array) -> jax.Array:
        """x = C⁻¹ b. Real b → rfftn path; complex b → full fftn path.

        Accepts b as the zyx grid or flat (C-order) and returns the same
        layout. jnp.fft.irfftn already applies the 1/N normalization, so the
        reference's explicit VecScale (FftLinearSolver_3D.c:183-187) has no
        analog here.
        """
        g, was_flat = self._as_grid(b)
        if jnp.iscomplexobj(g):
            x = _solve_cfft(g, self.lam_full)
        else:
            x = _solve_rfft(g, self.lam_rfft, self.shape_zyx).astype(g.dtype)
        return x.reshape(-1) if was_flat else x

    @jax.jit
    def matvec(self, u: jax.Array) -> jax.Array:
        """Apply C via its stencil: C u = u + Σ_d λ_d (u - roll(u, 1, d)).

        C1 has first column [1,-1,…] ⇒ (C1 u)_i = u_i - u_{i-1} on each axis.
        Cheap residual checks / explicit periodic stepping without any dense
        or sparse matrix.
        """
        g, was_flat = self._as_grid(u)
        out = g
        for ax, lam in enumerate(self.lambdas_zyx):
            if lam != 0.0:
                out = out + lam * (g - jnp.roll(g, 1, axis=ax))
        return out.reshape(-1) if was_flat else out

    def as_preconditioner(self) -> jax.tree_util.Partial:
        """M⁻¹ hook for Krylov solvers (flat-vector in/out); pytree-callable
        so the spectrum enters the solver executable as a runtime parameter."""
        return jax.tree_util.Partial(_circulant_pc_apply, self)


def _circulant_pc_apply(op, r):
    return op.solve(r.reshape(op.shape_zyx)).reshape(-1)


@jax.tree_util.register_pytree_node_class
@dataclass
class BlockCirculantOperator:
    """(m×m)-block circulant direct solver: periodic block stencils (wave system).

    The reference only sketches the block-circulant case ("block-circulant"
    ambition in the project name; scalar-only code). Here: given a periodic
    block stencil {offset o (zyx) → B_o ∈ R^{m×m}} the operator is
    block-circulant and the DFT diagonalizes it into per-frequency m×m
    systems Λ̂(k) = Σ_o B_o e^{2πi k·o/n}. We batch-invert Λ̂ once at setup
    (pre-inverted symbol cached on device); each solve is
    FFT over space axes → einsum('...ij,...j->...i', Λ̂⁻¹, b̂) → IFFT.
    """

    shape_zyx: tuple[int, ...]
    m: int
    # Pre-inverted symbol (*shape_zyx, m, m), stored as (re, im) real pair.
    inv_symbol_re: jax.Array
    inv_symbol_im: jax.Array

    def tree_flatten(self):
        return (self.inv_symbol_re, self.inv_symbol_im), (self.shape_zyx, self.m)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape_zyx, m = aux
        return cls(shape_zyx, m, *children)

    @property
    def inv_symbol(self) -> jax.Array:
        return jax.lax.complex(self.inv_symbol_re, self.inv_symbol_im)

    @staticmethod
    def np_symbol(
        shape_zyx: Sequence[int],
        offsets: Sequence[Sequence[int]],
        blocks: np.ndarray,
    ) -> np.ndarray:
        """Host-side block symbol Λ̂(k) = Σ_o B_o e^{2πi k·o/n} (complex128)."""
        shape_zyx = tuple(int(n) for n in shape_zyx)
        blocks = np.asarray(blocks)
        m = blocks.shape[-1]
        ndim = len(shape_zyx)
        sym = np.zeros(shape_zyx + (m, m), dtype=np.complex128)
        for off, B in zip(offsets, blocks):
            phase = np.zeros(shape_zyx, dtype=np.complex128)
            for ax in range(ndim):
                if off[ax] == 0:
                    continue
                n = shape_zyx[ax]
                k = np.arange(n)
                bshape = [1] * ndim
                bshape[ax] = n
                phase = phase + (2j * np.pi * off[ax] * k / n).reshape(bshape)
            sym = sym + np.exp(phase)[..., None, None] * B
        return sym

    @classmethod
    def from_stencil(
        cls,
        shape_zyx: Sequence[int],
        offsets: Sequence[Sequence[int]],
        blocks: np.ndarray,  # (n_offsets, m, m)
        dtype=jnp.float32,
    ):
        shape_zyx = tuple(int(n) for n in shape_zyx)
        m = np.asarray(blocks).shape[-1]
        sym = cls.np_symbol(shape_zyx, offsets, blocks)
        inv = np.linalg.inv(sym)
        return cls(
            shape_zyx,
            m,
            jnp.asarray(inv.real, dtype=dtype),
            jnp.asarray(inv.imag, dtype=dtype),
        )

    @jax.jit
    def solve(self, b: jax.Array) -> jax.Array:
        """b shaped (*shape_zyx, m) or flat (N*m,) cell-major (matching the
        reference's interleaved j*nbComp+comp layout, WaveSystem.cxx:78-90)."""
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx + (self.m,))
        space_axes = tuple(range(len(self.shape_zyx)))
        b_hat = jnp.fft.fftn(g, axes=space_axes)
        x_hat = jnp.einsum("...ij,...j->...i", self.inv_symbol, b_hat)
        x = jnp.fft.ifftn(x_hat, axes=space_axes)
        if not jnp.iscomplexobj(b):
            x = x.real.astype(b.dtype)
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(BlockCirculantOperator.solve, self)
