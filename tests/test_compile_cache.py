"""Placement of the persistent compilation cache, and the default transform."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.utils import compile_cache
from circulantpreconditioner_tpu.utils import enable_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_follows_environment(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_defaults_to_ignored_dir_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == compile_cache.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.dirname(path) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert os.path.basename(path) + "/" in f.read().split()


def test_transform_method_is_the_auto_choice():
    """"auto" in the models means transform_method(); both transforms give
    the same direct solve."""
    from circulantpreconditioner_tpu.mesh import cartesian_mesh
    from circulantpreconditioner_tpu.models import TransportEquation
    from circulantpreconditioner_tpu.ops.circulant import transform_method

    method = transform_method()
    assert method in ("fft", "matmul")
    model = TransportEquation(cartesian_mesh(((-0.5, 0.5),) * 3, (6, 8, 4), periodic=True),
                              (1.0, 0.5, 0.25), dtype=jnp.float64)
    u0 = model.initial_state()
    u_auto = np.asarray(model.fft_stepper()(u0)[0])
    u_same = np.asarray(model.fft_stepper(method=method)(u0)[0])
    u_other = np.asarray(model.fft_stepper(
        method="matmul" if method == "fft" else "fft")(u0)[0])
    np.testing.assert_array_equal(u_auto, u_same)
    np.testing.assert_allclose(u_other, u_auto, rtol=1e-10)
