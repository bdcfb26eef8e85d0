"""Linear transport equation ∂t u + a·∇u = 0 — problem class and steppers.

Capability parity with the reference's transport stack:
- spherical-explosion IC (650 inside r<0.3 of the domain center, else 600) —
  src/TransportEquation.cxx:25-73,
- dt = cfl · minRatioVolSurf / ‖a‖ — tests/TransportEquationFFT_...cxx:45-46,
- upwind divergence matrix (ops/assembly.py; reference sign defect fixed),
- three solve paths mirroring the reference drivers:
  explicit SpMV stepping, implicit GMRES (TransportEquation_..._impl_mpi.cxx),
  and the circulant FFT direct solve (TransportEquationFFT_..._impl_mpi.cxx)
  with the spectrum cached on device across all steps.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh.core import Mesh
from circulantpreconditioner_tpu.ops.assembly import transport_divergence_csr
from circulantpreconditioner_tpu.ops.circulant import CirculantTransportOperator
from circulantpreconditioner_tpu.ops.csr import CSRMatrix
from circulantpreconditioner_tpu.solvers.gmres import make_gmres


def spherical_explosion_scalar(mesh: Mesh, inside: float = 650.0, outside: float = 600.0,
                               rmax: float = 0.3) -> np.ndarray:
    """Reference IC: `inside` within radius rmax of the domain center
    (TransportEquation.cxx initial_conditions_shock)."""
    bbox = mesh.bbox()
    center = bbox.mean(axis=1)
    r = np.linalg.norm(mesh.cell_center - center[None, :], axis=1)
    return np.where(r < rmax, inside, outside)


# --- module-level jitted step impls: operators arrive as pytree ARGUMENTS,
# so one compiled executable serves every mesh/λ/dt of the same shapes
# (closure-captured arrays would be inlined as HLO constants and force a
# fresh compile per problem) ---------------------------------------------------


@jax.jit
def _explicit_step_impl(D, u):
    du = D(u)
    return u - du, jnp.linalg.norm(du)


@jax.jit
def _direct_step_impl(solver, u):
    u1 = solver.solve(u.reshape(solver.shape_zyx)).reshape(-1)
    return u1, jnp.linalg.norm(u1 - u)


def _identity_plus(D, u):
    return u + D(u)


@jax.jit
def _dnorm_impl(x, u):
    return jnp.linalg.norm(x - u)


class TransportEquation:
    def __init__(
        self,
        mesh: Mesh,
        velocity,
        cfl: float | None = None,
        dt: float | None = None,
        dtype=jnp.float32,
        boundary: str = "auto",
    ):
        self.mesh = mesh
        self.dim = mesh.dim
        self.velocity = np.asarray(velocity, dtype=np.float64)[: mesh.dim]
        self.dtype = dtype
        self.boundary = boundary
        if dt is not None:
            self.dt = float(dt)
        else:
            if cfl is None:
                cfl = 1e3 / mesh.dim  # reference default (TransportEquationFFT...cxx:232)
            self.dt = float(cfl * mesh.min_ratio_vol_surf() / np.linalg.norm(self.velocity))

    def initial_state(self) -> jax.Array:
        return jnp.asarray(spherical_explosion_scalar(self.mesh), dtype=self.dtype)

    @cached_property
    def divergence(self) -> CSRMatrix:
        """D such that (I + D)uⁿ⁺¹ = uⁿ (implicit) / uⁿ⁺¹ = uⁿ − D uⁿ (explicit)."""
        return transport_divergence_csr(
            self.mesh, self.dt, self.velocity, dtype=self.dtype, boundary=self.boundary
        )

    @cached_property
    def fft_operator(self) -> CirculantTransportOperator:
        """The circulant direct solver for I + D on a structured periodic
        grid (the reference FFT driver treats the structured mesh as periodic
        regardless of tagged BCs — same here, by construction of C)."""
        if not self.mesh.is_structured:
            raise ValueError("fft_operator requires a structured mesh")
        n_xyz = self.mesh.structured_shape
        h = np.asarray(self.mesh.spacing)  # type: ignore[attr-defined]
        return CirculantTransportOperator.from_transport(
            n_xyz, self.velocity, self.dt, h, dtype=self.dtype
        )

    def _stencil_bc(self) -> str | None:
        """'periodic' / 'neumann' when the structured mesh supports the
        stencil fast path (non-Periodic boundary groups are all no-ops in the
        transport assembly, i.e. Neumann-equivalent)."""
        if not self.mesh.is_structured:
            return None
        codes = set(np.unique(self.mesh.face_group)) - {0}
        names = {n for n, c in self.mesh.groups.items() if c in codes}
        if names <= {"Periodic"}:
            return "periodic"
        if "Periodic" not in names:
            return "neumann"
        return None  # mixed periodic/non-periodic axes: use the matrix

    @cached_property
    def stencil_operator(self):
        from circulantpreconditioner_tpu.ops.stencil import TransportStencilOperator

        bc = self._stencil_bc()
        if bc is None:
            raise ValueError("stencil operator needs a structured mesh with "
                             "homogeneous (all-periodic or no-periodic) boundaries")
        return TransportStencilOperator.create(
            self.mesh.structured_shape, self.velocity, self.dt,
            self.mesh.spacing, bc=bc)  # type: ignore[attr-defined]

    def divergence_op(self, operator: str = "auto"):
        """D as a pytree-callable: 'stencil' (gather-free structured fast
        path), 'varying' (gather-free per-cell-coefficient stencil for
        topologically structured meshes, e.g. Kershaw), 'window' (clustered
        dense windows for bandwidth-ordered unstructured meshes), 'matrix'
        (assembled CSR), or 'auto'."""
        if operator == "auto":
            if self._stencil_bc():
                operator = "stencil"
            elif getattr(self.mesh, "topology_shape", None) is not None:
                operator = "varying"
            elif getattr(self.mesh, "bandwidth_ordered", False):
                operator = "window"
            else:
                operator = "matrix"
        if operator == "stencil":
            return self.stencil_operator.matvec_partial()
        if operator == "window":
            from circulantpreconditioner_tpu.ops.window_spmv import (
                WindowedBlockOperator,
            )

            return WindowedBlockOperator.from_csr(
                self.divergence, dtype=self.dtype).matvec_partial()
        if operator == "varying":
            from circulantpreconditioner_tpu.ops.stencil import VaryingStencilOperator

            return VaryingStencilOperator.from_csr(
                self.divergence, self.mesh.topology_shape,
                cells_per_site=getattr(self.mesh, "cells_per_site", 1)).matvec_partial()  # type: ignore[attr-defined]
        return self.divergence.matvec_partial()

    # --- steppers -----------------------------------------------------------
    def explicit_stepper(self, operator: str = "auto"):
        D = self.divergence_op(operator)
        return lambda u: _explicit_step_impl(D, u)

    def implicit_matvec(self, operator: str = "auto"):
        """A = I + D as a pytree-callable (runtime-parameter operator)."""
        return jax.tree_util.Partial(_identity_plus, self.divergence_op(operator))

    def implicit_stepper(self, M=None, rtol: float = 1e-5, atol: float = 1e-5,
                         maxiter: int = 1000, restart: int = 30, side: str = "left",
                         operator: str = "auto"):
        """GMRES path (reference: GMRES + PCNONE,
        TransportEquation_..._impl_mpi.cxx:33-36); pass M for the circulant PC
        (side="right" for rank-deficient projection PCs)."""
        solver = make_gmres(self.implicit_matvec(operator), M, restart=restart,
                            rtol=rtol, atol=atol, maxiter=maxiter, side=side)

        def step(u):
            res = solver(u, u)
            return res.x, _dnorm_impl(res.x, u), res.iters, res.resnorm, res.converged

        return step

    def fft_stepper(self, method: str = "auto"):
        """Direct circulant solve per step (reference FFT driver), spectrum
        cached on device — fixes the reference's per-step plan rebuild.

        method: "fft" (jnp.fft path), "matmul" (DFT by dense matmul,
        ops/dft_matmul.py), or "auto" (ops.circulant.transform_method()).
        """
        from circulantpreconditioner_tpu.ops.circulant import transform_method

        op = self.fft_operator
        if method == "auto":
            method = transform_method()
        if method == "matmul":
            from circulantpreconditioner_tpu.ops.dft_matmul import MatmulCirculantSolver

            solver = MatmulCirculantSolver.from_operator(op)
        else:
            solver = op
        return lambda u: _direct_step_impl(solver, u)
