"""MatmulCirculantSolver (DFT-by-matmul path) vs the FFT path and dense oracles."""

import numpy as np
import pytest

import jax.numpy as jnp

from circulantpreconditioner_tpu.ops.circulant import CirculantTransportOperator
from circulantpreconditioner_tpu.ops.dft_matmul import MatmulCirculantSolver


@pytest.mark.parametrize("shape_zyx,lams", [
    ((16,), (2.0,)),
    ((15,), (0.5,)),       # odd n: hermitian weight path
    ((6, 8), (0.3, 1.5)),
    ((4, 6, 8), (0.2, 0.7, 3.0)),
    ((3, 5, 7), (0.2, 0.7, 3.0)),  # all odd
])
def test_matmul_solver_matches_fft_solver(shape_zyx, lams):
    op = CirculantTransportOperator.create(shape_zyx, lams, jnp.float64)
    mm = MatmulCirculantSolver.from_operator(op)
    rng = np.random.default_rng(0)
    b = rng.random(shape_zyx)
    x_fft = np.asarray(op.solve(jnp.asarray(b)))
    x_mm = np.asarray(mm.solve(jnp.asarray(b)))
    np.testing.assert_allclose(x_mm, x_fft, atol=1e-10)
    # flat input path
    x_flat = np.asarray(mm.solve(jnp.asarray(b.reshape(-1))))
    np.testing.assert_allclose(x_flat, x_fft.reshape(-1), atol=1e-10)


def test_matmul_solver_residual_f32():
    shape = (16, 16, 16)
    op = CirculantTransportOperator.create(shape, (0.5, 0.5, 5.0), jnp.float32)
    mm = MatmulCirculantSolver.from_operator(op)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.random(shape).astype(np.float32))
    x = mm.solve(b)
    r = np.asarray(op.matvec(x)) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-5


def test_block_matmul_solver_matches_fft_block_solver():
    from circulantpreconditioner_tpu.ops.circulant import BlockCirculantOperator
    from circulantpreconditioner_tpu.ops.dft_matmul import MatmulBlockCirculantSolver

    rng = np.random.default_rng(7)
    for shape in [(6,), (4, 6), (3, 4, 6), (3, 5, 7)]:
        m = 3
        ndim = len(shape)
        offsets = [(0,) * ndim]
        blocks = [np.eye(m) * 4.0]
        for ax in range(ndim):
            for s in (-1, 1):
                off = [0] * ndim
                off[ax] = s
                offsets.append(tuple(off))
                blocks.append(rng.normal(size=(m, m)) * 0.3)
        blocks = np.stack(blocks)
        ref = BlockCirculantOperator.from_stencil(shape, offsets, blocks, jnp.float64)
        mm = MatmulBlockCirculantSolver.from_stencil(shape, offsets, blocks, jnp.float64)
        b = rng.random(int(np.prod(shape)) * m)
        x_ref = np.asarray(ref.solve(jnp.asarray(b)))
        x_mm = np.asarray(mm.solve(jnp.asarray(b)))
        np.testing.assert_allclose(x_mm, x_ref, atol=1e-9, err_msg=f"shape={shape}")


def test_wave_block_matmul_stepper_matches_fft_stepper():
    from circulantpreconditioner_tpu.mesh import cartesian_mesh
    from circulantpreconditioner_tpu.models import WaveSystem

    mh = cartesian_mesh(((-0.5, 0.5),) * 2, (8, 6), periodic=True)
    model = WaveSystem(mh, cfl=50.0, dtype=jnp.float64)
    U0 = model.initial_state()
    U_fft, _ = model.block_fft_stepper(method="fft")(U0)
    U_mm, _ = model.block_fft_stepper(method="matmul")(U0)
    np.testing.assert_allclose(np.asarray(U_mm), np.asarray(U_fft), rtol=1e-9, atol=1e-4)
