"""Circulant solve via DFT-by-matmul: every transform is a dense GEMM.

The alternative to the jnp.fft path (ops/circulant.py); which of the two a
model uses by default is `ops.circulant.transform_method()`. The matmul form
is plain batched GEMM, so it exposes matmul precision control (`precision`:
"highest" = full float32, "high"/"default" = the backend's fast tier, TF32
on an H100) that the FFT path cannot.

All arithmetic is REAL (complex carried as (re, im) pairs).

Math. For the x axis we use the half-spectrum (rfft) transform:
    X[k] = Σ_j u[j] W^{jk},  W = e^{-2πi/nx},  k = 0..nx//2
packed as re/im (nx → nxr = nx//2+1 columns). y and z axes use full complex
DFT matrices. The inverse x transform back to real uses the hermitian
weights w_k (1 for k=0 and k=nx/2-if-even, else 2):
    u[j] = (1/nx) Σ_k w_k [re[k] cos(2πjk/nx) − im[k] sin(2πjk/nx)].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.ops.circulant import (
    CirculantTransportOperator,
    np_eigenvalue_diagonal,
)

_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def _np_dft_mats(n: int):
    k = np.arange(n)
    W = np.exp(-2j * np.pi * np.outer(k, k) / n)
    Winv = np.exp(2j * np.pi * np.outer(k, k) / n) / n
    return W.real, W.imag, Winv.real, Winv.imag


def _np_rdft_mats(n: int):
    nr = n // 2 + 1
    j = np.arange(n)
    k = np.arange(nr)
    ang = -2 * np.pi * np.outer(j, k) / n
    F_re = np.cos(ang)  # (n, nr)
    F_im = np.sin(ang)
    w = np.full(nr, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    angi = 2 * np.pi * np.outer(k, j) / n
    B_re = (w[:, None] * np.cos(angi)) / n  # (nr, n): u = re@B_re + im@B_im
    B_im = (-w[:, None] * np.sin(angi)) / n
    return F_re, F_im, B_re, B_im


def _dft_mats(n: int, dtype):
    return tuple(jnp.asarray(m, dtype=dtype) for m in _np_dft_mats(n))


def _rdft_mats(n: int, dtype):
    return tuple(jnp.asarray(m, dtype=dtype) for m in _np_rdft_mats(n))


def _axis_cdft(re, im, C, S, axis, ndim, precision):
    """Complex DFT along `axis` by matmul: (re+i·im) ← (re+i·im)·(C+i·S)."""
    sub = "zyx"[3 - ndim:]
    a = sub[axis]
    spec = f"{sub},{a}k->{sub.replace(a, 'k')}"
    ein = lambda x, M: jnp.einsum(spec, x, M, preferred_element_type=re.dtype,
                                  precision=precision)
    re2 = ein(re, C) - ein(im, S)
    im2 = ein(re, S) + ein(im, C)
    return re2, im2


@jax.tree_util.register_pytree_node_class
@dataclass
class MatmulCirculantSolver:
    """Same capability as CirculantTransportOperator.solve (real input), with
    every transform as a matmul. Shapes up to 3D; axis order zyx."""

    shape_zyx: tuple[int, ...]
    arrays: tuple  # (lam parts + DFT matrices), all real device arrays
    # "highest" (full float32 — direct-solver grade) or "high"/"default"
    # (the backend's fast matmul tier: TF32 on an H100, about three decimal
    # digits — preconditioner grade only)
    precision: str = "highest"
    # z/y axes actually transformed (positions into shape_zyx[:-1]); None =
    # all. Axes with λ=0 may be elided EXACTLY: Λ is independent of their
    # frequencies so F⁻¹·diag(Λ)·F cancels on them (ops/spectral_collapse.py)
    axes: tuple[int, ...] | None = None

    def tree_flatten(self):
        return (self.arrays,), (self.shape_zyx, self.precision, self.axes)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (arrays,) = children
        return cls(aux[0], arrays, aux[1], aux[2])

    @classmethod
    def create(cls, shape_zyx: Sequence[int], lambdas_zyx: Sequence[float], dtype=jnp.float32,
               precision: str = "highest", elide_zero_axes: bool = False):
        shape_zyx = tuple(int(v) for v in shape_zyx)
        lam = np_eigenvalue_diagonal(shape_zyx, lambdas_zyx, rfft=True)
        den = (lam.real**2 + lam.imag**2)
        inv_re = jnp.asarray(lam.real / den, dtype=dtype)
        inv_im = jnp.asarray(-lam.imag / den, dtype=dtype)  # 1/λ precomputed
        nx = shape_zyx[-1]
        F_re, F_im, B_re, B_im = _rdft_mats(nx, dtype)
        mats = []
        axes = []
        for i, n in enumerate(shape_zyx[:-1]):
            if elide_zero_axes and float(lambdas_zyx[i]) == 0.0:
                continue  # exact: Λ does not depend on this axis's frequency
            mats.append(_dft_mats(n, dtype))
            axes.append(i)
        return cls(shape_zyx, (inv_re, inv_im, F_re, F_im, B_re, B_im, tuple(mats)),
                   precision, tuple(axes))

    @classmethod
    def from_operator(cls, op: CirculantTransportOperator, precision: str = "highest"):
        return cls.create(op.shape_zyx, op.lambdas_zyx, dtype=op.lam_rfft_re.dtype,
                          precision=precision)

    @jax.jit
    def solve(self, b: jax.Array) -> jax.Array:
        """x = C⁻¹ b for real b shaped (*shape_zyx) or flat."""
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx)
        inv_re, inv_im, F_re, F_im, B_re, B_im, mats = self.arrays
        prec = _PRECISIONS[self.precision]
        ndim = len(self.shape_zyx)
        sub = "zyx"[3 - ndim:]
        # forward half-spectrum transform along x (real input)
        spec_x = f"{sub},xk->{sub[:-1]}k"
        re = jnp.einsum(spec_x, g, F_re, preferred_element_type=g.dtype, precision=prec)
        im = jnp.einsum(spec_x, g, F_im, preferred_element_type=g.dtype, precision=prec)
        axes = self.axes if self.axes is not None else tuple(range(len(mats)))
        # forward full transforms along remaining axes (z, y)
        for ax_i, (C, S, _, _) in zip(axes, mats):
            re, im = _axis_cdft(re, im, C, S, ax_i, ndim, prec)
        # multiply by precomputed 1/Λ
        re, im = re * inv_re - im * inv_im, re * inv_im + im * inv_re
        # inverse transforms along z, y
        for ax_i, (_, _, Ci, Si) in zip(axes, mats):
            re, im = _axis_cdft(re, im, Ci, Si, ax_i, ndim, prec)
        # inverse half-spectrum transform back to real along x
        spec_b = f"{sub[:-1]}k,kx->{sub}"
        x = jnp.einsum(spec_b, re, B_re, preferred_element_type=g.dtype, precision=prec) + \
            jnp.einsum(spec_b, im, B_im, preferred_element_type=g.dtype, precision=prec)
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(MatmulCirculantSolver.solve, self)


def _axis_cdft_b(re, im, C, S, axis, ndim, precision):
    """Complex DFT along spatial `axis` by matmul, with a trailing block dim m."""
    sub = "zyx"[3 - ndim:] + "m"
    a = sub[axis]
    spec = f"{sub},{a}k->{sub.replace(a, 'k')}"
    ein = lambda x, M: jnp.einsum(spec, x, M, preferred_element_type=re.dtype,
                                  precision=precision)
    re2 = ein(re, C) - ein(im, S)
    im2 = ein(re, S) + ein(im, C)
    return re2, im2


@jax.tree_util.register_pytree_node_class
@dataclass
class MatmulBlockCirculantSolver:
    """Block-circulant direct solver ((m×m) blocks — the wave system) with
    every DFT axis as a matmul and the pre-inverted half-spectrum block
    symbol applied as a batched complex matvec. DFT-matmul companion to
    ops/circulant.BlockCirculantOperator (which uses jnp.fft internally).
    """

    shape_zyx: tuple[int, ...]
    m: int
    arrays: tuple
    precision: str = "highest"

    def tree_flatten(self):
        return (self.arrays,), (self.shape_zyx, self.m, self.precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (arrays,) = children
        return cls(aux[0], aux[1], arrays, aux[2])

    @classmethod
    def from_stencil(cls, shape_zyx: Sequence[int], offsets, blocks,
                     dtype=jnp.float32, precision: str = "highest"):
        from circulantpreconditioner_tpu.ops.circulant import BlockCirculantOperator

        shape_zyx = tuple(int(v) for v in shape_zyx)
        m = np.asarray(blocks).shape[-1]
        sym = BlockCirculantOperator.np_symbol(shape_zyx, offsets, blocks)
        nxr = shape_zyx[-1] // 2 + 1
        sym = sym[..., :nxr, :, :]  # hermitian symmetry: half x-spectrum
        inv = np.linalg.inv(sym)
        nx = shape_zyx[-1]
        F_re, F_im, B_re, B_im = _rdft_mats(nx, dtype)
        mats = tuple(_dft_mats(n, dtype) for n in shape_zyx[:-1])
        return cls(
            shape_zyx, m,
            (jnp.asarray(inv.real, dtype=dtype), jnp.asarray(inv.imag, dtype=dtype),
             F_re, F_im, B_re, B_im, mats),
            precision,
        )

    @jax.jit
    def solve(self, b: jax.Array) -> jax.Array:
        """b flat cell-major (N·m,) or shaped (*shape_zyx, m); real."""
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx + (self.m,))
        inv_re, inv_im, F_re, F_im, B_re, B_im, mats = self.arrays
        prec = _PRECISIONS[self.precision]
        ndim = len(self.shape_zyx)
        sub = "zyx"[3 - ndim:] + "m"
        # x-axis half-spectrum forward: 'zyxm,xk->zykm'
        spec_fwd = f"{sub},xk->{sub[:-2]}km"
        re = jnp.einsum(spec_fwd, g, F_re, preferred_element_type=g.dtype, precision=prec)
        im = jnp.einsum(spec_fwd, g, F_im, preferred_element_type=g.dtype, precision=prec)
        for ax_i, (C, S, _, _) in enumerate(mats):
            re, im = _axis_cdft_b(re, im, C, S, ax_i, ndim, prec)
        # block apply: (inv_re + i·inv_im) @ (re + i·im)
        re, im = (
            jnp.einsum("...ij,...j->...i", inv_re, re, precision=prec)
            - jnp.einsum("...ij,...j->...i", inv_im, im, precision=prec),
            jnp.einsum("...ij,...j->...i", inv_re, im, precision=prec)
            + jnp.einsum("...ij,...j->...i", inv_im, re, precision=prec),
        )
        for ax_i, (_, _, Ci, Si) in enumerate(mats):
            re, im = _axis_cdft_b(re, im, Ci, Si, ax_i, ndim, prec)
        spec_bwd = f"{sub[:-2]}km,kx->{sub}"
        x = jnp.einsum(spec_bwd, re, B_re, preferred_element_type=g.dtype, precision=prec) + \
            jnp.einsum(spec_bwd, im, B_im, preferred_element_type=g.dtype, precision=prec)
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(MatmulBlockCirculantSolver.solve, self)
