"""Slab-decomposed distributed 3D circulant solve over a device mesh.

Replacement for the reference's FFTW-MPI slab FFT
(MatCreateFFT(PETSC_COMM_WORLD, …, MATFFTW), TransportEquationFFT_...cxx:100)
including the packed-real-format cross-rank machinery it needed
(VecPointwiseDivideForRealFFT, FftLinearSolver_3D.c:27-77) — all of which
collapses here to two all_to_all transposes inside one jitted shard_map:

    b (nz/P, ny, nxr) slab per device           (sharded on z)
      └ local rfft2 over (y, x)
      └ all_to_all: split y, gather z  → (nz, ny/P, nxr)   [ICI transpose]
      └ local fft over z
      └ divide by the LOCAL Λ slice  Λ[:, y-slab, :]       (no communication:
        Λ is separable — each shard computes its slice with iota math)
      └ local ifft over z
      └ all_to_all back: split z, gather y → (nz/P, ny, nxr)
      └ local irfft2
    x slab per device

The whole pipeline is one pjit'd program, so XLA overlaps the transposes
with the per-slab FFT compute. The spectrum slices are device-resident and
built once (host NumPy → device_put sharded), fixing the reference's
per-step plan rebuild.

The same machinery exposes distributed forward FFT/IFFT for general use.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from circulantpreconditioner_tpu.ops.circulant import (
    CirculantTransportOperator,
    np_eigenvalue_diagonal,
)


class SlabCirculantSolver:
    """Distributed analog of CirculantTransportOperator.solve for 3D grids,
    sharded by z-slabs over one mesh axis. Requires nz % P == 0 and
    ny % P == 0 (slab↔pencil transpose divisibility, same constraint as
    FFTW-MPI's default slab decomposition)."""

    def __init__(
        self,
        shape_zyx: tuple[int, int, int],
        lambdas_zyx: tuple[float, float, float],
        mesh: Mesh,
        axis: str = "shard",
        dtype=jnp.float32,
    ):
        nz, ny, nx = shape_zyx
        self.P = mesh.shape[axis]
        if nz % self.P or ny % self.P:
            raise ValueError(f"nz={nz} and ny={ny} must be divisible by P={self.P}")
        self.shape_zyx = shape_zyx
        self.mesh = mesh
        self.axis = axis
        self.dtype = dtype
        nxr = nx // 2 + 1

        lam = np_eigenvalue_diagonal(shape_zyx, lambdas_zyx, rfft=True)  # (nz,ny,nxr)
        # Λ sharded over the y axis (the post-transpose local layout)
        y_sharding = NamedSharding(mesh, P(None, axis, None))
        self.lam_re = jax.device_put(np.ascontiguousarray(lam.real).astype(dtype), y_sharding)
        self.lam_im = jax.device_put(np.ascontiguousarray(lam.imag).astype(dtype), y_sharding)
        self.z_sharding = NamedSharding(mesh, P(axis, None, None))

        axis_name = axis

        def local_solve(b_loc, lre, lim):
            # b_loc: (nz/P, ny, nx) real; lre/lim: (nz, ny/P, nxr)
            bh = jnp.fft.rfft2(b_loc, axes=(1, 2))  # (nz/P, ny, nxr) complex
            bh = jax.lax.all_to_all(bh, axis_name, split_axis=1, concat_axis=0, tiled=True)
            # (nz, ny/P, nxr)
            bh = jnp.fft.fft(bh, axis=0)
            xh = bh / jax.lax.complex(lre, lim)
            xh = jnp.fft.ifft(xh, axis=0)
            xh = jax.lax.all_to_all(xh, axis_name, split_axis=0, concat_axis=1, tiled=True)
            # (nz/P, ny, nxr)
            x = jnp.fft.irfft2(xh, axes=(1, 2), s=(b_loc.shape[1], b_loc.shape[2]))
            return x.astype(b_loc.dtype)

        self._solve = jax.jit(
            jax.shard_map(
                local_solve,
                mesh=mesh,
                in_specs=(P(axis, None, None), P(None, axis, None), P(None, axis, None)),
                out_specs=P(axis, None, None),
            )
        )

    @classmethod
    def from_operator(cls, op: CirculantTransportOperator, mesh: Mesh, axis: str = "shard"):
        if len(op.shape_zyx) != 3:
            raise ValueError("slab solver is 3D")
        return cls(op.shape_zyx, op.lambdas_zyx, mesh, axis,
                   dtype=op.lam_rfft_re.dtype)

    def shard(self, b) -> jax.Array:
        """Place a global (nz,ny,nx) array with z-slab sharding."""
        return jax.device_put(b, self.z_sharding)

    def solve(self, b: jax.Array) -> jax.Array:
        """x = C⁻¹ b; b is the (nz,ny,nx) global array (ideally already
        z-slab sharded; XLA reshards otherwise)."""
        return self._solve(b, self.lam_re, self.lam_im)


class PencilCirculantSolver:
    """Pencil-decomposed (2D device mesh) distributed circulant solve —
    scales past the slab limit P ≤ nz to p·q devices (the decomposition FFTW
    -MPI cannot do; the standard 2D-decomposition of large-scale 3D FFTs).

    Field (nz, ny, nx) is sharded (z over mesh axis `axes[0]`, y over
    `axes[1]`); the pipeline is x-pencils → rfft(x) → A2A(y-group) →
    fft(y) → A2A(z-group) → fft(z) → ÷Λ → inverse chain, all inside one
    jitted shard_map so XLA overlaps the ICI transposes with local FFTs.
    The x half-spectrum is zero-padded to a multiple of q so the transpose
    tiles evenly (padded bins carry Λ=1 and are sliced off before the
    inverse rfft).

    Requires nz % p == 0, ny % q == 0, ny % p == 0.
    """

    def __init__(
        self,
        shape_zyx: tuple[int, int, int],
        lambdas_zyx: tuple[float, float, float],
        mesh: Mesh,
        axes: tuple[str, str] = ("z", "y"),
        dtype=jnp.float32,
    ):
        nz, ny, nx = shape_zyx
        az, ay = axes
        p, q = mesh.shape[az], mesh.shape[ay]
        if nz % p or ny % q or ny % p:
            raise ValueError(
                f"need nz%p==0, ny%q==0, ny%p==0 (nz={nz}, ny={ny}, p={p}, q={q})"
            )
        self.shape_zyx = shape_zyx
        self.mesh = mesh
        self.axes = axes
        self.dtype = dtype
        nxr = nx // 2 + 1
        nxr_pad = ((nxr + q - 1) // q) * q

        lam = np_eigenvalue_diagonal(shape_zyx, lambdas_zyx, rfft=True)  # (nz,ny,nxr)
        lam_pad = np.ones((nz, ny, nxr_pad), dtype=lam.dtype)  # padded bins: Λ=1
        lam_pad[:, :, :nxr] = lam
        spec_lam = NamedSharding(mesh, P(None, az, ay))
        self.lam_re = jax.device_put(np.ascontiguousarray(lam_pad.real).astype(dtype), spec_lam)
        self.lam_im = jax.device_put(np.ascontiguousarray(lam_pad.imag).astype(dtype), spec_lam)
        self.in_sharding = NamedSharding(mesh, P(az, ay, None))

        def local_solve(b_loc, lre, lim):
            # b_loc: (nz/p, ny/q, nx) real
            bh = jnp.fft.rfft(b_loc, axis=2)  # (nz/p, ny/q, nxr)
            bh = jnp.pad(bh, ((0, 0), (0, 0), (0, nxr_pad - nxr)))
            bh = jax.lax.all_to_all(bh, ay, split_axis=2, concat_axis=1, tiled=True)
            bh = jnp.fft.fft(bh, axis=1)  # (nz/p, ny, nxr_pad/q)
            bh = jax.lax.all_to_all(bh, az, split_axis=1, concat_axis=0, tiled=True)
            bh = jnp.fft.fft(bh, axis=0)  # (nz, ny/p, nxr_pad/q)
            xh = bh / jax.lax.complex(lre, lim)
            xh = jnp.fft.ifft(xh, axis=0)
            xh = jax.lax.all_to_all(xh, az, split_axis=0, concat_axis=1, tiled=True)
            xh = jnp.fft.ifft(xh, axis=1)  # (nz/p, ny, nxr_pad/q)
            xh = jax.lax.all_to_all(xh, ay, split_axis=1, concat_axis=2, tiled=True)
            x = jnp.fft.irfft(xh[:, :, :nxr], n=b_loc.shape[2], axis=2)
            return x.astype(b_loc.dtype)

        self._solve = jax.jit(
            jax.shard_map(
                local_solve,
                mesh=mesh,
                in_specs=(P(az, ay, None), P(None, az, ay), P(None, az, ay)),
                out_specs=P(az, ay, None),
            )
        )

    @classmethod
    def from_operator(cls, op: CirculantTransportOperator, mesh: Mesh,
                      axes: tuple[str, str] = ("z", "y")):
        if len(op.shape_zyx) != 3:
            raise ValueError("pencil solver is 3D")
        return cls(op.shape_zyx, op.lambdas_zyx, mesh, axes,
                   dtype=op.lam_rfft_re.dtype)

    def shard(self, b) -> jax.Array:
        return jax.device_put(b, self.in_sharding)

    def solve(self, b: jax.Array) -> jax.Array:
        return self._solve(b, self.lam_re, self.lam_im)


def make_distributed_fft3(mesh: Mesh, axis: str = "shard", inverse: bool = False):
    """General slab-decomposed complex 3D FFT over the mesh axis: returns a
    jitted (nz,ny,nx)→(nz,ny,nx) transform (z-slab sharded in and out)."""
    axis_name = axis

    def local_fft(v):
        f1 = jnp.fft.ifft if inverse else jnp.fft.fft
        vh = jnp.fft.ifft2(v, axes=(1, 2)) if inverse else jnp.fft.fft2(v, axes=(1, 2))
        vh = jax.lax.all_to_all(vh, axis_name, split_axis=1, concat_axis=0, tiled=True)
        vh = f1(vh, axis=0)
        vh = jax.lax.all_to_all(vh, axis_name, split_axis=0, concat_axis=1, tiled=True)
        return vh

    return jax.jit(
        jax.shard_map(
            local_fft,
            mesh=mesh,
            in_specs=(P(axis, None, None),),
            out_specs=P(axis, None, None),
        )
    )
