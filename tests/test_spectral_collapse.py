"""Axis elision / dense spectral collapse (ops/spectral_collapse.py).

These are EXACT reformulations of the circulant solve — every test asserts
agreement with the full multi-axis DFT pipeline (MatmulCirculantSolver) and,
through it, with the operator residual. The flagship case is the reference's
own configuration: transport velocity a=(1,0,0)
(/root/reference/tests/TransportEquation_SphericalExplosion_impl_mpi.cxx:258-259),
for which the full 3D FFT the reference performs per solve
(/root/reference/src/FftLinearSolver_3D.c:166-190) provably collapses to one
dense matmul along x.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.ops.circulant import CirculantTransportOperator
from circulantpreconditioner_tpu.ops.dft_matmul import MatmulCirculantSolver
from circulantpreconditioner_tpu.ops.spectral_collapse import (
    DenseCirculantSolver,
    IdentitySolver,
    make_circulant_solver,
)


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_dense_collapse_matches_full_pipeline_3d(axis):
    shape = (6, 5, 8)
    lams = [0.0, 0.0, 0.0]
    lams[axis] = 3.7
    full = MatmulCirculantSolver.create(shape, lams, jnp.float32, precision="highest")
    dense = DenseCirculantSolver.create(shape, lams, jnp.float32, precision="highest")
    b = _rand(shape)
    np.testing.assert_allclose(np.asarray(dense.solve(b)), np.asarray(full.solve(b)),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,lams", [((16,), (2.0,)), ((8, 12), (0.0, 1.5))])
def test_dense_collapse_lower_ranks(shape, lams):
    full = MatmulCirculantSolver.create(shape, lams, jnp.float32, precision="highest")
    dense = DenseCirculantSolver.create(shape, lams, jnp.float32, precision="highest")
    b = _rand(shape, 1)
    np.testing.assert_allclose(np.asarray(dense.solve(b)), np.asarray(full.solve(b)),
                               rtol=0, atol=2e-5)


def test_dense_collapse_residual_against_operator():
    """The gate bench.py enforces: residual vs the FULL 3D operator."""
    n = 24
    lams = (0.0, 0.0, 5.0)
    op = CirculantTransportOperator.create((n, n, n), lams, jnp.float32)
    dense = DenseCirculantSolver.create((n, n, n), lams, jnp.float32)
    b = _rand((n, n, n), 2) + 10.0
    x = dense.solve(b)
    r = float(jnp.linalg.norm(op.matvec(x) - b) / jnp.linalg.norm(b))
    assert r < 1e-4


def test_staged_elision_matches_full():
    """λz = 0, λy,λx ≠ 0: the z-DFT pair is skipped exactly."""
    shape = (6, 5, 8)
    lams = (0.0, 2.0, 1.0)
    full = MatmulCirculantSolver.create(shape, lams, jnp.float32, precision="highest")
    elided = MatmulCirculantSolver.create(shape, lams, jnp.float32, precision="highest",
                                          elide_zero_axes=True)
    assert elided.axes == (1,)
    assert len(elided.arrays[-1]) == 1  # one DFT-matrix set, not two
    b = _rand(shape, 3)
    np.testing.assert_allclose(np.asarray(elided.solve(b)), np.asarray(full.solve(b)),
                               rtol=0, atol=2e-5)


def test_factory_dispatch():
    assert isinstance(make_circulant_solver((4, 4, 4), (0, 0, 0)), IdentitySolver)
    assert isinstance(make_circulant_solver((4, 4, 4), (0, 0, 2.0)), DenseCirculantSolver)
    s = make_circulant_solver((4, 4, 4), (0, 1.0, 2.0))
    assert isinstance(s, MatmulCirculantSolver) and s.axes == (1,)
    s = make_circulant_solver((4, 4, 4), (1.0, 1.0, 2.0))
    assert isinstance(s, MatmulCirculantSolver) and s.axes == (0, 1)
    full = make_circulant_solver((4, 4, 4), (0, 0, 2.0), elide_zero_axes=False)
    assert isinstance(full, MatmulCirculantSolver)


def test_identity_solver():
    s = make_circulant_solver((4, 4), (0.0, 0.0))
    b = _rand((4, 4), 4)
    np.testing.assert_array_equal(np.asarray(s.solve(b)), np.asarray(b))


def test_solvers_jit_as_pytrees():
    """Solvers are runtime parameters of one jitted executable (the drivers
    pass them through jit boundaries as pytrees)."""
    shape = (4, 6, 8)
    s1 = make_circulant_solver(shape, (0, 0, 1.0))
    s2 = make_circulant_solver(shape, (0, 0, 2.0))

    @jax.jit
    def run(s, b):
        return s.solve(b)

    b = _rand(shape, 5)
    np.testing.assert_allclose(np.asarray(run(s1, b)), np.asarray(s1.solve(b)), atol=1e-6)
    np.testing.assert_allclose(np.asarray(run(s2, b)), np.asarray(s2.solve(b)), atol=1e-6)
