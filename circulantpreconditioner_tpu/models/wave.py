"""Linear wave system ∂t(p,q) + div F = 0 — problem class and steppers.

Capability parity with the reference's WaveSystem stack
(src/WaveSystem.cxx + the four WaveSystem_SphericalExplosion drivers):
- physics constants p0=155e5, c0=700 (src/WaveSystem.hxx:16-19; note the
  reference's rho0 = p0/c0*c0 evaluates left-to-right to p0 — unused in the
  solves, reproduced here only as documentation),
- spherical-explosion IC: p=155e5 inside r<0.3 else 70e5, velocity 0
  (WaveSystem.cxx:25-76),
- dt = cfl · minRatioVolSurf / c0 (WaveSystem_..._expl_seq.cxx:72),
- block upwind divergence (ops/assembly.py) with Wall/Periodic/Neumann BCs,
- explicit SpMV stepping, implicit GMRES + {none, pbjacobi, ILU0, block-
  circulant} preconditioning, and — beyond the reference — a block-circulant
  FFT DIRECT solver on periodic structured grids.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh.core import Mesh
from circulantpreconditioner_tpu.ops.assembly import wave_block_stencil, wave_divergence_bsr
from circulantpreconditioner_tpu.ops.circulant import BlockCirculantOperator
from circulantpreconditioner_tpu.ops.csr import BSRMatrix
from circulantpreconditioner_tpu.solvers.gmres import make_gmres

P0 = 155e5  # reference pressure (pressurised vessel), WaveSystem.hxx:16
C0 = 700.0  # sound speed, WaveSystem.hxx:17


def spherical_explosion_wave(mesh: Mesh, p_in: float = P0, p_out: float = 70e5,
                             rmax: float = 0.3) -> np.ndarray:
    """(nC, dim+1) state: pressure + zero velocity (WaveSystem.cxx:25-76)."""
    bbox = mesh.bbox()
    center = bbox.mean(axis=1)
    r = np.linalg.norm(mesh.cell_center - center[None, :], axis=1)
    U = np.zeros((mesh.n_cells, mesh.dim + 1))
    U[:, 0] = np.where(r < rmax, p_in, p_out)
    return U


# module-level jitted step impls (operators as pytree args — one compile per
# shape, not per matrix; see transport.py for rationale)


@jax.jit
def _explicit_step_impl(D, U):
    dU = D(U)
    return U - dU, jnp.linalg.norm(dU)


@jax.jit
def _blockfft_step_impl(op, U):
    U1 = op.solve(U)
    return U1, jnp.linalg.norm(U1 - U)


@jax.jit
def _dctfft_step_fm_impl(op, G):
    """Field-major direct step: G (nb, nC) — op.shape_zyx is static aux."""
    shp = G.shape
    G1 = op.solve_fm(G.reshape((op.nb,) + op.shape_zyx)).reshape(shp)
    return G1, jnp.linalg.norm(G1 - G)


def _identity_plus(D, U):
    return U + D(U)


@jax.jit
def _dnorm_impl(x, u):
    return jnp.linalg.norm(x - u)


class WaveSystem:
    def __init__(
        self,
        mesh: Mesh,
        c0: float = C0,
        cfl: float | None = None,
        dt: float | None = None,
        dtype=jnp.float32,
    ):
        self.mesh = mesh
        self.dim = mesh.dim
        self.c0 = float(c0)
        self.nb = mesh.dim + 1
        self.dtype = dtype
        if dt is not None:
            self.dt = float(dt)
        else:
            if cfl is None:
                cfl = 1.0 / mesh.dim  # explicit-driver default (..._expl_seq.cxx:177)
            self.dt = float(cfl * mesh.min_ratio_vol_surf() / self.c0)

    def initial_state(self) -> jax.Array:
        """Flat cell-major state (nC·(dim+1),) matching the reference's
        interleaved j·nbComp+comp layout."""
        return jnp.asarray(spherical_explosion_wave(self.mesh).reshape(-1), dtype=self.dtype)

    @cached_property
    def divergence(self) -> BSRMatrix:
        return wave_divergence_bsr(self.mesh, self.dt, self.c0, dtype=self.dtype)

    def _homogeneous_bc(self) -> str | None:
        """'wall' / 'periodic' when the structured mesh has uniform boundary
        groups (the stencil fast path's requirement), else None."""
        if not self.mesh.is_structured:
            return None
        codes = set(np.unique(self.mesh.face_group)) - {0}
        names = {n for n, c in self.mesh.groups.items() if c in codes}
        if names <= {"Wall"}:
            return "wall"
        if names <= {"Periodic"}:
            return "periodic"
        return None

    @cached_property
    def stencil_operator(self):
        """Gather-free stencil form of D (structured grids; ops/stencil.py)."""
        from circulantpreconditioner_tpu.ops.stencil import WaveStencilOperator

        bc = self._homogeneous_bc()
        if bc is None:
            raise ValueError("stencil operator needs a structured mesh with "
                             "homogeneous Wall or Periodic boundaries")
        return WaveStencilOperator.from_model(self, bc=bc)

    def divergence_op(self, operator: str = "auto"):
        """The D operator as a pytree-callable: 'stencil' (structured fast
        path), 'varying' (gather-free per-cell-block stencil on topologically
        structured meshes, e.g. the Kershaw family), 'window' (clustered
        dense windows for bandwidth-ordered unstructured meshes — the tetra
        fixture families), 'matrix' (assembled BSR), or 'auto'."""
        if operator == "auto":
            if self._homogeneous_bc():
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

            return WindowedBlockOperator.from_bsr(
                self.divergence, dtype=self.dtype).matvec_partial()
        if operator in ("varying", "normal"):
            from circulantpreconditioner_tpu.ops.stencil import (
                VaryingStencilOperator,
                WaveNormalStencilOperator,
            )

            V = VaryingStencilOperator.from_bsr(
                self.divergence, self.mesh.topology_shape,
                cells_per_site=getattr(self.mesh, "cells_per_site", 1))  # type: ignore[attr-defined]
            if getattr(self.mesh, "cells_per_site", 1) == 1:
                # physics-structured normal form: 2.8× less coefficient
                # traffic; exact decomposition or None
                Wn = WaveNormalStencilOperator.from_varying(V, self.c0)
                if Wn is not None:
                    return Wn.matvec_partial()
            if operator == "normal":
                raise ValueError("wave normal-form decomposition failed for this mesh")
            return V.matvec_partial()
        return self.divergence.matvec_partial()

    @cached_property
    def block_circulant_operator(self) -> BlockCirculantOperator:
        """Direct block-circulant solver of I + D on a periodic structured
        grid — the 'block-circulant' goal of the reference project, realized."""
        if not self.mesh.is_structured:
            raise ValueError("block_circulant_operator requires a structured mesh")
        h = np.asarray(self.mesh.spacing)  # type: ignore[attr-defined]
        offsets, blocks = wave_block_stencil(self.dim, self.dt, self.c0, h)
        shape_zyx = tuple(reversed(self.mesh.structured_shape))
        return BlockCirculantOperator.from_stencil(shape_zyx, offsets, blocks, dtype=self.dtype)

    def divergence_op_fm(self, operator: str = "auto", flat: bool = False):
        """Field-major D: input/output (dim+1, nC) — or flat (dim+1)·nC
        vectors with flat=True (for Krylov solvers). Available for the
        gather-free stencil forms (flat/grid_last layouts); None otherwise.
        The (N,m)↔(m,N) relayouts inside the cell-major `matvec` can cost
        more than the stencil body itself, so loops that can keep the state
        field-major should. On a GPU the flat normal-form stencil runs as
        the Triton-route Pallas kernel (ops/pallas_stencil.py): at Kershaw
        64³ on an H100 (700 W) 27.3 µs per apply against 31.8 µs for the
        XLA form, and the implicit gridmg step 17.2 against 18.2 ms."""
        from circulantpreconditioner_tpu.ops.stencil import (
            VaryingStencilOperator,
            WaveNormalStencilOperator,
        )

        if operator == "auto":
            operator = ("varying" if getattr(self.mesh, "topology_shape", None)
                        is not None else "matrix")
        if operator not in ("varying", "normal"):
            return None
        try:
            V = VaryingStencilOperator.from_bsr(
                self.divergence, self.mesh.topology_shape,
                cells_per_site=getattr(self.mesh, "cells_per_site", 1))  # type: ignore[attr-defined]
        except ValueError:
            # topology_shape is set but the operator is not a 7-point
            # face-neighbour stencil (e.g. extra couplings from periodic
            # tagging): honor the documented None fallback for probe callers,
            # keep the raise for an explicit 'normal' request
            if operator == "normal":
                raise
            return None
        if V.layout not in ("flat", "grid_last"):
            return None
        if getattr(self.mesh, "cells_per_site", 1) == 1:
            Wn = WaveNormalStencilOperator.from_varying(V, self.c0)
            if Wn is not None:
                if jax.default_backend() == "gpu":
                    from circulantpreconditioner_tpu.ops.pallas_stencil import (
                        make_plane_stencil_matvec,
                    )

                    mv = make_plane_stencil_matvec(Wn)
                    if mv is not None:
                        return mv  # shape-agnostic: (m,N)/grid/flat
                return (Wn.matvec_fm_flat_partial() if flat
                        else Wn.matvec_fm_partial())
        if operator == "normal":  # same contract as divergence_op: no
            raise ValueError(     # silent downgrade to the dense blocks
                "wave normal-form decomposition failed for this mesh")
        g = int(getattr(self.mesh, "cells_per_site", 1))
        if g > 1 and V.layout == "flat":
            from circulantpreconditioner_tpu.ops.stencil import (
                SupercellStencilOperator,
            )

            # block-sparse supercell form: ~8× less coefficient traffic
            # than the dense (g·nb)² einsum blocks (see the class docstring)
            S = SupercellStencilOperator.from_varying(V, self.nb, g)
            if S is not None:
                return S.matvec_fm_flat_partial() if flat else S.matvec_fm_partial()
        return V.matvec_fm_flat_partial() if flat else V.matvec_fm_partial()

    @property
    def fm_block(self) -> int:
        """Field-major granularity: dim+1 components per cell, times the
        supercell grouping on meshes whose stencil SITE packs several cells
        (tet meshes: 6 cells/site → 24-row field view)."""
        return self.nb * int(getattr(self.mesh, "cells_per_site", 1))

    def pack_fm(self, U) -> jax.Array:
        """Flat cell-major state → field-major (fm_block, nSites) array."""
        return jnp.asarray(np.asarray(U).reshape(-1, self.fm_block).T.copy(),
                           dtype=self.dtype)

    def unpack_fm(self, G) -> np.ndarray:
        """Field-major (fm_block, nSites) or flat → flat cell-major."""
        return np.asarray(G).reshape(self.fm_block, -1).T.reshape(-1)

    # --- steppers -----------------------------------------------------------
    def explicit_stepper(self, operator: str = "auto"):
        D = self.divergence_op(operator)
        return lambda U: _explicit_step_impl(D, U)

    def explicit_stepper_fm(self, operator: str = "auto"):
        """Field-major explicit stepper, or None when the mesh has no
        gather-free stencil form. State is (dim+1, nC); use pack_fm /
        unpack_fm at the I/O boundaries."""
        D = self.divergence_op_fm(operator)
        if D is None:
            return None
        return lambda G: _explicit_step_impl(D, G)

    def implicit_matvec(self, operator: str = "auto"):
        """A = I + D as a pytree-callable (runtime-parameter operator)."""
        return jax.tree_util.Partial(_identity_plus, self.divergence_op(operator))

    def implicit_stepper(self, M=None, rtol: float = 1e-5, atol: float = 1e-5,
                         maxiter: int = 1000, restart: int = 30, side: str = "left",
                         operator: str = "auto"):
        """GMRES (+ILU seq / BJACOBI mpi in the reference; any M here)."""
        solver = make_gmres(self.implicit_matvec(operator), M, restart=restart,
                            rtol=rtol, atol=atol, maxiter=maxiter, side=side)

        def step(U):
            res = solver(U, U)
            return res.x, _dnorm_impl(res.x, U), res.iters, res.resnorm, res.converged

        return step

    def implicit_matvec_fm(self, operator: str = "auto"):
        """I + D on FIELD-MAJOR flat vectors, or None when the mesh has no
        gather-free stencil form. The matvec pays no (N,m)↔(m,N) relayouts
        (see divergence_op_fm). Supercell meshes (cells_per_site > 1) are
        excluded: their field-major flattening groups fm_block=site·(dim+1)
        rows, which the per-CELL preconditioner compositions
        (pbjacobi_fm, cell_major_adapter) would silently mis-index."""
        if int(getattr(self.mesh, "cells_per_site", 1)) != 1:
            return None
        D = self.divergence_op_fm(operator, flat=True)
        if D is None:
            return None
        return jax.tree_util.Partial(_identity_plus, D)

    def implicit_stepper_fm(self, M_cm=None, M_fm=None, rtol: float = 1e-5,
                            atol: float = 1e-5, maxiter: int = 1000,
                            restart: int = 30, side: str = "left",
                            operator: str = "auto"):
        """Field-major GMRES implicit stepper (state = flat field-major
        vectors, x.reshape(dim+1, nC) is the field view), or None when no
        gather-free stencil form exists. M_cm: a cell-major preconditioner
        apply (Partial), wrapped with ONE relayout pair per apply — versus
        one pair per MATVEC in the cell-major stepper. M_fm: an already
        field-major apply (e.g. pcs.pbjacobi_fm); both given = additive."""
        from circulantpreconditioner_tpu.solvers import preconditioners as pcs

        A = self.implicit_matvec_fm(operator)
        if A is None:
            return None
        terms = []
        if M_cm is not None:
            terms.append(pcs.cell_major_adapter(M_cm, self.nb))
        if M_fm is not None:
            terms.append(M_fm)
        M = pcs.additive(*terms) if len(terms) > 1 else (terms[0] if terms else None)
        solver = make_gmres(A, M, restart=restart, rtol=rtol, atol=atol,
                            maxiter=maxiter, side=side)

        def step(G):
            res = solver(G, G)
            return res.x, _dnorm_impl(res.x, G), res.iters, res.resnorm, res.converged

        return step

    def dct_fft_stepper(self):
        """DIRECT wall-BC solve of (I + D)Uⁿ⁺¹ = Uⁿ via the exact DCT/DST
        block diagonalization (ops/dct_wave.py) — the wall-boundary
        counterpart of block_fft_stepper, replacing GMRES entirely on the
        reference's default cartesian wall meshes
        (WaveSystem_..._impl_seq.cxx runs GMRES+ILU on exactly this
        operator). Exactness vs the assembled FV operator is asserted to
        1e-13 in tests/test_dct_wave.py."""
        from circulantpreconditioner_tpu.ops.dct_wave import DCTBlockWaveSolver

        if self._homogeneous_bc() != "wall":
            raise ValueError("dct_fft_stepper needs a structured mesh with "
                             "uniform Wall boundaries")
        shape_zyx = tuple(reversed(self.mesh.structured_shape))  # type: ignore[attr-defined]
        op = DCTBlockWaveSolver.create(shape_zyx, self.dim, self.dt, self.c0,
                                       self.mesh.spacing, dtype=self.dtype)  # type: ignore[attr-defined]
        return lambda U: _blockfft_step_impl(op, U)

    def dct_fft_stepper_fm(self):
        """FIELD-MAJOR DCT/DST direct stepper: state (nb, nC) (pack_fm /
        unpack_fm at the I/O boundaries). The per-step (…,nb)↔(nb,…)
        relayouts the cell-major stepper pays cost ~6× the entire solve
        pipeline at 64³ (ops/dct_wave.solve_fm docstring) — this is the
        production loop."""
        from circulantpreconditioner_tpu.ops.dct_wave import DCTBlockWaveSolver

        if self._homogeneous_bc() != "wall":
            raise ValueError("dct_fft_stepper needs a structured mesh with "
                             "uniform Wall boundaries")
        shape_zyx = tuple(reversed(self.mesh.structured_shape))  # type: ignore[attr-defined]
        op = DCTBlockWaveSolver.create(shape_zyx, self.dim, self.dt, self.c0,
                                       self.mesh.spacing, dtype=self.dtype)  # type: ignore[attr-defined]
        return lambda G: _dctfft_step_fm_impl(op, G)

    def block_fft_stepper(self, method: str = "auto"):
        """Block-circulant direct solve per step (periodic structured grids).
        method: "fft" (jnp.fft path), "matmul" (DFT by dense matmul), or
        "auto" (ops.circulant.transform_method())."""
        from circulantpreconditioner_tpu.ops.circulant import transform_method

        if method == "auto":
            method = transform_method()
        if method == "matmul":
            from circulantpreconditioner_tpu.ops.dft_matmul import MatmulBlockCirculantSolver

            h = np.asarray(self.mesh.spacing)  # type: ignore[attr-defined]
            offsets, blocks = wave_block_stencil(self.dim, self.dt, self.c0, h)
            op = MatmulBlockCirculantSolver.from_stencil(
                tuple(reversed(self.mesh.structured_shape)), offsets, blocks,
                dtype=self.dtype)
        else:
            op = self.block_circulant_operator
        return lambda U: _blockfft_step_impl(op, U)

    def split_fields(self, U) -> tuple[np.ndarray, np.ndarray]:
        """Flat state → (pressure (nC,), velocity (nC, dim)) host arrays."""
        Un = np.asarray(U).reshape(-1, self.nb)
        return Un[:, 0], Un[:, 1:]
