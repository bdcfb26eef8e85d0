"""DiffusionEquation — the reference's named next capability.

The reference roadmap asks for a diffusion equation reusing the FFT solver
structure ("ajouter l'équation de diffusion ... StructuredDiffusionContext /
FFTPrecDiffusionContext", reference ToDo.md:5-6) plus exact solutions for
verification (ToDo.md:8). This model provides:

- TPFA FV diffusion operator D = dt·ν·L (ops/assembly.diffusion_csr), with
  the same auto stencil/varying/matrix dispatch as the other models;
- implicit stepper via CG (L is SPD — CG is the right Krylov method here,
  unlike the transport/wave GMRES) or GMRES;
- FFT direct stepper: the StructuredDiffusionContext analog — diffusive
  circulant symbol 1 + Σ_d 2λ_d(1 − cos θ_d), λ_d = ν·dt/h_d², solved by
  the m=1 block-circulant solver (transform by ops.circulant.transform_method);
- exact solutions (`exact_mode_decay`): periodic Fourier modes decay by
  1/(1 + dt·ν·λ_h(k)) per implicit step with λ_h the DISCRETE symbol —
  machine-precision oracles used in tests/test_diffusion.py.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh.core import Mesh
from circulantpreconditioner_tpu.models.transport import (
    _direct_step_impl,
    _dnorm_impl,
    _explicit_step_impl,
    _identity_plus,
    spherical_explosion_scalar,
)
from circulantpreconditioner_tpu.ops.assembly import diffusion_csr, diffusion_stencil
from circulantpreconditioner_tpu.ops.csr import CSRMatrix
from circulantpreconditioner_tpu.solvers import make_cg, make_gmres


class DiffusionEquation:
    """∂t u = ν ∇²u, first-order FV in space, implicit/explicit Euler in
    time. `cfl` scales the explicit stability limit dt ≤ r²/(2·dim·ν) with
    r = min |V|/|∂V| (cfl=1 is the stable explicit step; implicit runs take
    cfl ≫ 1 like the reference's transport drivers)."""

    def __init__(
        self,
        mesh: Mesh,
        nu: float = 1.0,
        cfl: float | None = None,
        dt: float | None = None,
        dtype=jnp.float32,
        boundary: str = "auto",
    ):
        self.mesh = mesh
        self.dim = mesh.dim
        self.nu = float(nu)
        self.dtype = dtype
        self.boundary = boundary
        if dt is not None:
            self.dt = float(dt)
        else:
            if cfl is None:
                cfl = 1e3 / mesh.dim
            r = mesh.min_ratio_vol_surf()
            self.dt = float(cfl * r * r / (2.0 * mesh.dim * self.nu))

    def initial_state(self) -> jax.Array:
        return jnp.asarray(spherical_explosion_scalar(self.mesh), dtype=self.dtype)

    @cached_property
    def divergence(self) -> CSRMatrix:
        """D = dt·ν·L such that (I + D)uⁿ⁺¹ = uⁿ."""
        return diffusion_csr(self.mesh, self.dt, self.nu, dtype=self.dtype,
                             boundary=self.boundary)

    def divergence_op(self, operator: str = "auto"):
        if operator == "auto":
            operator = (
                "varying" if getattr(self.mesh, "topology_shape", None) is not None
                else "matrix"
            )
        if operator == "varying":
            from circulantpreconditioner_tpu.ops.stencil import VaryingStencilOperator

            return VaryingStencilOperator.from_csr(
                self.divergence, self.mesh.topology_shape,
                cells_per_site=getattr(self.mesh, "cells_per_site", 1)).matvec_partial()  # type: ignore[attr-defined]
        return self.divergence.matvec_partial()

    def implicit_matvec(self, operator: str = "auto"):
        return jax.tree_util.Partial(_identity_plus, self.divergence_op(operator))

    # --- steppers -----------------------------------------------------------
    def explicit_stepper(self, operator: str = "auto"):
        D = self.divergence_op(operator)
        return lambda u: _explicit_step_impl(D, u)

    def implicit_stepper(self, M=None, rtol: float = 1e-5, atol: float = 1e-5,
                         maxiter: int = 1000, method: str = "cg",
                         operator: str = "auto"):
        """I + D is SPD on insulated/periodic meshes → CG by default."""
        A = self.implicit_matvec(operator)
        if method == "cg":
            solver = make_cg(A, M, rtol=rtol, atol=atol, maxiter=maxiter)
        else:
            solver = make_gmres(A, M, rtol=rtol, atol=atol, maxiter=maxiter)

        def step(u):
            res = solver(u, u)
            return res.x, _dnorm_impl(res.x, u), res.iters, res.resnorm, res.converged

        return step

    @cached_property
    def fft_solver(self):
        """StructuredDiffusionContext analog: direct solve of I + D on a
        periodic uniform grid by ops.circulant.transform_method(), symbol
        cached on device."""
        from circulantpreconditioner_tpu.ops.circulant import (
            BlockCirculantOperator,
            transform_method,
        )
        from circulantpreconditioner_tpu.ops.dft_matmul import MatmulBlockCirculantSolver

        if not self.mesh.is_structured:
            raise ValueError("fft stepper needs a cartesian mesh")
        shape_zyx = tuple(reversed(self.mesh.structured_shape))
        offsets, blocks = diffusion_stencil(
            self.dim, self.dt, self.nu, self.mesh.spacing)  # type: ignore[attr-defined]
        blocks = blocks.copy()
        blocks[0] += 1.0  # identity shift: symbol of I + D
        cls = (MatmulBlockCirculantSolver if transform_method() == "matmul"
               else BlockCirculantOperator)
        return cls.from_stencil(shape_zyx, offsets, blocks, dtype=self.dtype)

    def fft_stepper(self):
        solver = self.fft_solver
        return lambda u: _direct_step_impl(solver, u)

    # --- exact solutions (reference ToDo.md:8) ------------------------------
    def discrete_symbol(self, k_xyz) -> float:
        """λ_h(k) = Σ_d 2ν(1 − cos(2π k_d h_d / L_d))/h_d² — the eigenvalue
        of the DISCRETE operator L at integer mode k on the periodic grid."""
        assert self.mesh.is_structured
        h = np.asarray(self.mesh.spacing, dtype=np.float64)  # type: ignore[attr-defined]
        n = np.asarray(self.mesh.structured_shape, dtype=np.float64)
        k = np.asarray(k_xyz, dtype=np.float64)[: self.dim]
        theta = 2.0 * np.pi * k / n
        return float((2.0 * self.nu * (1.0 - np.cos(theta)) / (h * h)).sum())

    def exact_mode_decay(self, k_xyz, n_steps: int) -> float:
        """Amplitude factor of mode k after n implicit-Euler steps:
        (1 + dt·λ_h(k))^{-n} — exact for the discrete system."""
        return float((1.0 + self.dt * self.discrete_symbol(k_xyz)) ** (-n_steps))
