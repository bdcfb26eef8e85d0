"""Wall-BC (reflective) block direct solver for the wave system via DCT/DST.

The periodic block-circulant preconditioner (solvers/circulant_pc.py) uses a
PERIODIC cartesian operator while the FV wave operator has WALL mirror
boundaries (reference /root/reference/src/WaveSystem.cxx:150-157, assembled
here by ops/assembly.wave_divergence_bsr: the wall face adds −Am·2vvᵀ to the
center block — exactly the mirror-ghost closure u_ghost = (I − 2vvᵀ)·u).
That boundary mismatch bounds the PC's effectiveness. This module removes it.

Math. On a uniform cartesian grid with mirror walls, the implicit upwind
wave operator I + D is EXACTLY block-diagonalized by real mixed cosine/sine
transforms: expand the pressure p (and tangential velocities) in DCT-II
modes cos(πk(i+½)/n) and the axis-d normal velocity q_d in DST-II modes
sin(πm(i+½)/n) along axis d. Both families satisfy the mirror ghost
conditions identically (p_{-1}=p_0, q_{-1}=−q_0 and the same at i=n−1), and
per frequency the operator couples (P, Q_d) through a REAL (dim+1)×(dim+1)
block:

    B(t) = C + Σ_d [ 2cosθ_d · S_d  −  σ_d(c) · 2sinθ_d · K_d ],
    θ_d = π t_d / n_d,
    S_d = (B_d⁺ + B_d⁻)/2 = −λ_d|A_d|/2   (symmetric/diffusive part),
    K_d = (B_d⁺ − B_d⁻)/2 = +λ_d A_d/2    (antisymmetric/advective part),
    σ_d(c) = −1 iff component c is q_d (sine-type along axis d), else +1,

derived from the same wave_block_stencil blocks the periodic PC uses. The
cos family has n modes (k=0..n−1), the sin family n modes (m=1..n); both
are embedded in a COMMON frequency axis padded to F = roundup(n+1, 8) slots
(cos slot n and sin slot 0 are structurally zero; the couplings vanish
there because sinθ=0, so dead and live components never mix, and slots
beyond n+1 are all-zero rows whose inverse blocks are never read back).
The 8-alignment keeps odd (n+1)-extents out of the einsum layouts.
Everything is real: forward/backward transforms are (F, n) matmuls —
batched over the three cosine components per axis, plus one sine
transform — and the block solve is a pre-inverted real (…, nb, nb) tensor
contraction; no complex pairs at all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.ops.dft_matmul import _PRECISIONS


def _freq_slots(n: int) -> int:
    """Padded frequency extent: n+1 slots rounded up to a multiple of 8."""
    return ((n + 1) + 7) // 8 * 8


def _np_cos_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """DCT-II forward (F, n) with zero rows ≥ n, and its left inverse
    (n, F) with zero columns ≥ n."""
    F = _freq_slots(n)
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    T = np.zeros((F, n))
    T[:n] = np.cos(np.pi * k * (i + 0.5) / n)
    I = np.zeros((n, F))
    I[:, :n] = np.linalg.inv(T[:n])
    return T, I


def _np_sin_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """DST-II forward (F, n) with modes m=1..n in rows 1..n (row 0 and rows
    > n zero), and its left inverse (n, F)."""
    F = _freq_slots(n)
    m = np.arange(1, n + 1)[:, None]
    i = np.arange(n)[None, :]
    T = np.zeros((F, n))
    T[1:n + 1] = np.sin(np.pi * m * (i + 0.5) / n)
    I = np.zeros((n, F))
    I[:, 1:n + 1] = np.linalg.inv(T[1:n + 1])
    return T, I


def _np_wall_block_tensor(shape_zyx, dim, dt, c0, spacing_xyz) -> np.ndarray:
    """Pre-inverted real frequency blocks, shape (*(F_a,), nb, nb).

    Derived from the SAME wave_block_stencil blocks the periodic PC uses —
    S_a/K_a are the symmetric/antisymmetric halves of the ±e_a offset
    blocks and C is the center block — so the wall and periodic coarse
    operators can never drift apart if the stencil convention changes.
    Pad slots (index > n_a) use θ clamped to π: the symbol stays in its
    live range, hence invertible, and their solutions are never read back
    (the inverse-transform columns there are zero)."""
    from circulantpreconditioner_tpu.ops.assembly import wave_block_stencil

    ndim = len(shape_zyx)
    assert ndim == dim, (ndim, dim)
    nb = dim + 1
    offsets, blocks = wave_block_stencil(dim, dt, c0, spacing_xyz)
    bmap = {tuple(off): blk for off, blk in zip(offsets, np.asarray(blocks))}
    C = bmap[(0,) * ndim]
    S = {}
    K = {}
    for a in range(ndim):  # zyx axis position
        ep = tuple(1 if i == a else 0 for i in range(ndim))
        em = tuple(-1 if i == a else 0 for i in range(ndim))
        S[a] = 0.5 * (bmap[ep] + bmap[em])  # −λ|A|/2 (diffusive part)
        K[a] = 0.5 * (bmap[ep] - bmap[em])  # +λA/2  (advective part)
    # σ_a(c): −1 iff component c is the q of the xyz axis mapped to a
    sigma = np.ones((ndim, nb))
    for d in range(dim):
        sigma[ndim - 1 - d, 1 + d] = -1.0

    out_shape = tuple(_freq_slots(n) for n in shape_zyx)
    B = np.zeros(out_shape + (nb, nb))
    B[...] = C
    for a, n in enumerate(shape_zyx):
        F = out_shape[a]
        th = np.pi * np.minimum(np.arange(F), n) / n
        bshape = [1] * ndim
        bshape[a] = F
        cos2 = (2 * np.cos(th)).reshape(bshape + [1, 1])
        sin2 = (2 * np.sin(th)).reshape(bshape + [1, 1])
        B = B + cos2 * S[a] - sin2 * (K[a] * sigma[a][None, :])
    return np.linalg.inv(B)


@jax.tree_util.register_pytree_node_class
@dataclass
class DCTBlockWaveSolver:
    """Exact direct solver for the wall-BC cartesian wave operator I + D,
    all-real transforms as matmuls. Companion to
    ops/dft_matmul.MatmulBlockCirculantSolver (the periodic variant)."""

    shape_zyx: tuple[int, ...]
    nb: int
    arrays: tuple  # (inv_blocks, per-axis (Tc, Ic, Ts, Is))
    # full float32 matmuls: at 64³ on an H100 (400 W) "highest" solves in
    # 105 µs with residual 2.1e-5, the TF32 tier ("high") in 81 µs with 2.0e-2
    precision: str = "highest"

    def tree_flatten(self):
        return (self.arrays,), (self.shape_zyx, self.nb, self.precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (arrays,) = children
        return cls(aux[0], aux[1], arrays, aux[2])

    @classmethod
    def create(cls, shape_zyx: Sequence[int], dim: int, dt: float, c0: float,
               spacing_xyz, dtype=jnp.float32, precision: str = "highest"):
        shape_zyx = tuple(int(v) for v in shape_zyx)
        ndim = len(shape_zyx)
        nb = dim + 1
        inv = _np_wall_block_tensor(shape_zyx, dim, dt, c0, spacing_xyz)
        # component axes LEADING (i, j, *grid): the block-solve einsum then
        # contracts matching grid-major layouts instead of transposing the
        # ~24 MB tensor per solve
        inv = np.moveaxis(inv, (-2, -1), (0, 1))
        # per-axis PER-COMPONENT transform stacks (nb, F, n): component
        # 1+(ndim-1-a) rides the sine family, the rest the cosine family —
        # one batched einsum transforms all components in a single sweep
        mats = []
        for a, n in enumerate(shape_zyx):
            Tc, Ic = _np_cos_mats(n)
            Ts, Is = _np_sin_mats(n)
            sin_comp = 1 + (ndim - 1 - a)
            T = np.stack([Ts if c == sin_comp else Tc for c in range(nb)])
            I = np.stack([Is if c == sin_comp else Ic for c in range(nb)])
            mats.append((jnp.asarray(T, dtype=dtype), jnp.asarray(I, dtype=dtype)))
        return cls(shape_zyx, nb,
                   (jnp.asarray(inv, dtype=dtype), tuple(mats)), precision)

    @property
    def m(self) -> int:  # block size, MatmulBlockCirculantSolver-compatible
        return self.nb

    @jax.jit
    def solve_fm(self, gb: jax.Array) -> jax.Array:
        """FIELD-MAJOR solve: gb (nb, *shape_zyx) → same shape; real.

        Components ride the leading batch axis shared with the per-component
        transform stacks, so every grid axis is ONE batched einsum per
        direction. The cell-major `solve` wraps it in the (…, nb)↔(nb, …)
        relayout pair, which can cost more than the pipeline itself (the
        same minor-axis relayout as the stencil SpMV); production loops
        should stay field-major and pay it only at I/O."""
        inv, mats = self.arrays
        prec = _PRECISIONS[self.precision]
        ndim = len(self.shape_zyx)
        sub = "zyx"[3 - ndim:]

        def sweep(gb, a, fwd):
            T, I = mats[a]
            C = T if fwd else I
            ax = sub[a]
            spec = f"B{sub},Bw{ax}->B{sub.replace(ax, 'w')}"
            return jnp.einsum(spec, gb, C, preferred_element_type=gb.dtype,
                              precision=prec)

        for a in range(ndim):
            gb = sweep(gb, a, fwd=True)
        gb = jnp.einsum(f"ij{sub},j{sub}->i{sub}", inv, gb,
                        preferred_element_type=gb.dtype, precision=prec)
        for a in range(ndim):
            gb = sweep(gb, a, fwd=False)
        return gb

    @jax.jit
    def solve(self, b: jax.Array) -> jax.Array:
        """b shaped (*shape_zyx, nb) or flat (N·nb,) cell-major; real."""
        was_flat = b.ndim == 1
        g = b.reshape(self.shape_zyx + (self.nb,))
        gb = self.solve_fm(jnp.moveaxis(g, -1, 0))
        x = jnp.moveaxis(gb, 0, -1)
        return x.reshape(-1) if was_flat else x

    def as_preconditioner(self) -> jax.tree_util.Partial:
        return jax.tree_util.Partial(DCTBlockWaveSolver.solve, self)
