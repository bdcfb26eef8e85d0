"""Pallas (Triton route) kernel for the wave normal-form stencil SpMV.

Same operator as `WaveNormalStencilOperator.matvec_fm` on the flat layout:
every program owns BLOCK consecutive cells of the flattened grid (a slice of
a z-plane), loads the field at the cell and at its flat neighbour offsets
o ∈ {±1, ±nx, ±nx·ny} with masked loads (reads outside [0, N) give 0), and
writes the m output components. Flat-layout wrap positions carry zero
coefficients by construction (VaryingStencilOperator._flat_safe), so the
masked neighbour reads need no further guard. No state crosses programs.

Bytes per apply (float32): field in m·N, coefficients (m² + K + K·(m−1))·N,
field out m·N — 48 floats per cell in 3D. The neighbour reads hit the
caches, not device memory. At Kershaw 64³ (50.3 MB per apply) on an H100
(700 W): 27.3 µs = 1.84 TB/s, 64% of a 1 GiB copy in the same run
(2.89 TB/s), against 31.8 µs (55%) for the XLA form. The implicit gridmg step at
that size: 17.2 ms with this kernel, 18.2 ms with the XLA form (39 GMRES
iterations either way).

Reference parity: this is the MatMult of the explicit/implicit wave drivers
(src/WaveSystem.cxx:109-176 assembles it; tests/WaveSystem_..._expl_seq.cxx:90
applies it).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


# cells per program and warps per program: 256-2048 cells with 4 or 8 warps
# all measured within 27-31 µs at Kershaw 64³ on an H100; 512 / 4 was best
_BLOCK = 512
_NUM_WARPS = 4


def make_plane_stencil_matvec(Wn, interpret: bool = False):
    """Field-major matvec for a flat-layout WaveNormalStencilOperator, as a
    tree_util.Partial over its coefficient arrays. Accepts (m, N),
    (m, *grid) or flat (m·N,) field-major input and returns the same shape.
    Returns None when the operator is not flat-layout."""
    if Wn.layout != "flat":
        return None
    m = Wn.m
    dim = m - 1
    N = int(np.prod(Wn.shape_zyx))
    offs = tuple(int(o) for o in Wn.offsets)
    K = len(offs)
    c0 = float(Wn.c0)
    half = 0.5 * c0
    diag, s, nvec = Wn.arrays  # (m,m,N), (K,N), (K,dim,N)
    dtype = diag.dtype

    def kernel(x_ref, d_ref, s_ref, n_ref, o_ref):
        idx = pl.program_id(0) * _BLOCK + jnp.arange(_BLOCK)
        inb = idx < N

        def ld(ref, row, j=idx, mask=inb):
            return plgpu.load(ref.at[row * N + j], mask=mask, other=0.0)

        x0 = [ld(x_ref, c) for c in range(m)]
        ys = []
        for i in range(m):
            acc = ld(d_ref, i * m) * x0[0]
            for j in range(1, m):
                acc = acc + ld(d_ref, i * m + j) * x0[j]
            ys.append(acc)
        for k, o in enumerate(offs):
            j = idx + o
            mk = inb & (j >= 0) & (j < N)
            nbr = [ld(x_ref, c, j, mk) for c in range(m)]
            sk = ld(s_ref, k)
            nk = [ld(n_ref, k * dim + d) for d in range(dim)]
            t = nk[0] * nbr[1]
            for d in range(1, dim):
                t = t + nk[d] * nbr[1 + d]
            u = sk * (0.5 * nbr[0] - half * t)
            ys[0] = ys[0] + half * sk * (c0 * t - nbr[0])
            for d in range(dim):
                ys[1 + d] = ys[1 + d] + u * nk[d]
        for c in range(m):
            plgpu.store(o_ref.at[c * N + idx], ys[c], mask=inb)

    apply = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((m * N,), dtype),
        grid=(pl.cdiv(N, _BLOCK),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="wave_normal_stencil",
    )

    @jax.jit
    def matvec_plane(diag_, s_, nvec_, g: jax.Array) -> jax.Array:
        """g (m, N), (m, nz, ny, nx), or flat (m·N,) field-major → same."""
        out = apply(g.reshape(-1), diag_.reshape(-1), s_.reshape(-1),
                    nvec_.reshape(-1))
        return out.reshape(g.shape)

    return jax.tree_util.Partial(matvec_plane, diag, s, nvec)
