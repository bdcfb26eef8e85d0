"""Axis elision and dense spectral collapse for circulant solves.

Exact operator algebra, not an approximation: the implicit upwind transport
operator is C = I + Σᵢ λᵢ·(…⊗C1_{nᵢ}⊗…), so its spectrum
Λ(k) = 1 + Σᵢ λᵢ·ĉ(kᵢ) does not depend on the frequencies of axes with
λᵢ = 0. For those axes the similarity transform F_axis⁻¹·diag(Λ)·F_axis
cancels (diag(Λ) commutes with anything acting on an independent axis), so
their DFTs can be skipped entirely.

The reference's own flagship configuration is exactly this case: the
transport drivers fix the velocity a = (1,0,0)
(/root/reference/tests/TransportEquation_SphericalExplosion_impl_mpi.cxx:258-259,
TransportEquationFFT_...cxx: a along x), yet the reference still runs a full
3D FFTW transform per solve (/root/reference/src/FftLinearSolver_3D.c:166-190).
Exploiting the cancellation:

- exactly ONE nonzero λ (the reference default): the whole
  FFT → divide → IFFT pipeline collapses to a SINGLE precomputed real n×n
  matrix  M = Re(F⁻¹·diag(1/Λ₁d)·F)  applied along that axis — one matmul
  per solve, batched over every other grid point, reading the field once.
- SOME zero λs (≥2 nonzero): the staged DFT-matmul path skips the zero axes
  (MatmulCirculantSolver(elide_zero_axes=True)).
- all λ = 0: C = I; the solve is the identity.

M is assembled on host in float64 (the inverse is exact to ~1e-14 there;
f32 rounding of M costs ~4e-6 relative residual at 100³).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.ops.circulant import np_eigenvalue_diagonal
from circulantpreconditioner_tpu.ops.dft_matmul import _PRECISIONS, MatmulCirculantSolver


@jax.tree_util.register_pytree_node_class
@dataclass
class IdentitySolver:
    """C = I (all λ zero): the solve is a no-op."""

    shape_zyx: tuple[int, ...]

    def tree_flatten(self):
        return (), (self.shape_zyx,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0])

    def solve(self, b: jax.Array) -> jax.Array:
        return b

    def as_preconditioner(self):
        return jax.tree_util.Partial(IdentitySolver.solve, self)


@jax.tree_util.register_pytree_node_class
@dataclass
class DenseCirculantSolver:
    """Single-nonzero-axis circulant solve as ONE dense matmul along that
    axis: x = M·b with M = Re(F⁻¹ diag(1/Λ₁d) F) precomputed in float64."""

    shape_zyx: tuple[int, ...]
    axis: int  # index into shape_zyx of the transformed axis
    arrays: tuple  # (M,) — (n, n) real, rows = output index
    precision: str = "highest"

    def tree_flatten(self):
        return (self.arrays,), (self.shape_zyx, self.axis, self.precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (arrays,) = children
        return cls(aux[0], aux[1], arrays, aux[2])

    @classmethod
    def create(cls, shape_zyx: Sequence[int], lambdas_zyx: Sequence[float],
               dtype=jnp.float32, precision: str = "highest"):
        shape_zyx = tuple(int(v) for v in shape_zyx)
        nonzero = [i for i, l in enumerate(lambdas_zyx) if float(l) != 0.0]
        if len(nonzero) != 1:
            raise ValueError("DenseCirculantSolver needs exactly one nonzero λ; "
                             f"got {lambdas_zyx}")
        axis = nonzero[0]
        n = shape_zyx[axis]
        lam1 = np_eigenvalue_diagonal((n,), (float(lambdas_zyx[axis]),), rfft=False)
        k = np.arange(n)
        W = np.exp(-2j * np.pi * np.outer(k, k) / n)
        Winv = np.exp(2j * np.pi * np.outer(k, k) / n) / n
        M = (Winv @ np.diag(1.0 / lam1) @ W)
        # C is real ⇒ so is its inverse; the imaginary residue is fp noise
        assert np.abs(M.imag).max() < 1e-12 * max(1.0, np.abs(M.real).max())
        return cls(shape_zyx, axis, (jnp.asarray(M.real, dtype=dtype),), precision)

    @jax.jit
    def solve(self, b: jax.Array) -> jax.Array:
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx)
        (M,) = self.arrays
        ndim = len(self.shape_zyx)
        sub = "zyx"[3 - ndim:]
        a = sub[self.axis]
        spec = f"{sub},w{a}->{sub.replace(a, 'w')}"
        x = jnp.einsum(spec, g, M, preferred_element_type=g.dtype,
                       precision=_PRECISIONS[self.precision])
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(DenseCirculantSolver.solve, self)


def make_circulant_solver(shape_zyx: Sequence[int], lambdas_zyx: Sequence[float],
                          dtype=jnp.float32, precision: str = "highest",
                          elide_zero_axes: bool = True):
    """Pick the fastest exact formulation for C⁻¹ on this λ pattern.

    elide_zero_axes=False forces the full multi-axis DFT pipeline (useful
    for apples-to-apples benchmarking against the reference's always-3D
    FFTW path)."""
    lambdas = tuple(float(l) for l in lambdas_zyx)
    shape = tuple(int(v) for v in shape_zyx)
    nonzero = [i for i, l in enumerate(lambdas) if l != 0.0]
    if elide_zero_axes and not nonzero:
        return IdentitySolver(shape)
    if elide_zero_axes and len(nonzero) == 1:
        return DenseCirculantSolver.create(shape, lambdas, dtype, precision)
    # λx = 0 with several other axes nonzero still runs the x transform
    # (the rfft axis carries the real↔complex boundary); only z/y elide.
    return MatmulCirculantSolver.create(
        shape, lambdas, dtype, precision,
        elide_zero_axes=elide_zero_axes,
    )
