"""Pallas kernel tests (interpret mode on CPU; the compiled Triton path runs
on the GPU in chip_smoke.py's stencil check)."""

import numpy as np
import pytest

import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
from circulantpreconditioner_tpu.models import WaveSystem
from circulantpreconditioner_tpu.ops.pallas_stencil import make_plane_stencil_matvec
from circulantpreconditioner_tpu.ops.stencil import (
    VaryingStencilOperator,
    WaveNormalStencilOperator,
)


def _normal_form(n_xyz):
    m = kershaw_mesh(((0.0, 1.0),) * 3, n_xyz)
    model = WaveSystem(m, cfl=100.0, dtype=jnp.float64)
    V = VaryingStencilOperator.from_bsr(model.divergence, m.topology_shape)
    return m, WaveNormalStencilOperator.from_varying(V, model.c0)


@pytest.mark.parametrize("n_xyz", [(16, 8, 8), (16, 8, 5)],
                         ids=["whole_blocks", "partial_block"])
def test_plane_stencil_kernel_matches_fm_matvec(n_xyz):
    """The Triton-route stencil kernel (interpret mode) reproduces
    WaveNormalStencilOperator.matvec_fm: 1024 cells fill two programs
    exactly; with 640 the second program's block runs past the grid."""
    m, Wn = _normal_form(n_xyz)
    mv = make_plane_stencil_matvec(Wn, interpret=True)
    assert mv is not None
    rng = np.random.default_rng(0)
    g = jnp.asarray(rng.random((4, m.n_cells)))
    y, y_ref = np.asarray(mv(g)), np.asarray(Wn.matvec_fm(g))
    np.testing.assert_allclose(y, y_ref, rtol=1e-13,
                               atol=1e-13 * np.abs(y_ref).max())
    # flat field-major vectors round-trip in their own shape
    yf = np.asarray(mv(g.reshape(-1)))
    np.testing.assert_allclose(yf, y.reshape(-1), rtol=0, atol=0)


def test_plane_stencil_kernel_2d_and_layout_contract():
    """A 2D flat operator (m = 3) runs through the same kernel; a grid_last
    layout is refused."""
    import dataclasses

    from circulantpreconditioner_tpu.mesh import cartesian_mesh

    m = cartesian_mesh(((0.0, 1.0),) * 2, (6, 5))
    model = WaveSystem(m, cfl=10.0, dtype=jnp.float64)
    V = VaryingStencilOperator.from_bsr(model.divergence, (6, 5))
    Wn = WaveNormalStencilOperator.from_varying(V, model.c0)
    mv = make_plane_stencil_matvec(Wn, interpret=True)
    g = jnp.asarray(np.random.default_rng(1).random((3, m.n_cells)))
    np.testing.assert_allclose(np.asarray(mv(g)), np.asarray(Wn.matvec_fm(g)),
                               rtol=1e-13, atol=1e-13 * np.abs(np.asarray(Wn.matvec_fm(g))).max())
    assert make_plane_stencil_matvec(dataclasses.replace(Wn, layout="grid_last"),
                                     interpret=True) is None
