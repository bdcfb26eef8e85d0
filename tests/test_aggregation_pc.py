"""Aggregation multilevel V-cycle PC (solvers/aggregation_pc.py) — the
adaptive coarse space for the warped FVCA6 fixture meshes where the
cartesian projection PC measurably fails (round-4 negative result;
/root/reference/src/PCSHELLFft_3D.cxx:101-151 is the unfinished reference
analog)."""

import numpy as np

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh, tet_mesh
from circulantpreconditioner_tpu.models import WaveSystem
from circulantpreconditioner_tpu.solvers import make_gmres, preconditioners as pcs
from circulantpreconditioner_tpu.solvers.aggregation_pc import (
    AggregationVCyclePC,
    _Level,
    _prolong,
    _restrict,
)


def _wave(n_side=8, mesh_fn=kershaw_mesh):
    mesh = mesh_fn(((0.0, 1.0),) * 3, (n_side,) * 3)
    return WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)


def test_transfers_are_partition_of_unity():
    """R·P = I for the mean-restriction / piecewise-constant pair, including
    a ragged final aggregate."""
    n, b, factor = 11, 4, 4
    n_agg = -(-n // factor)
    cnt = np.bincount(np.arange(n) // factor, minlength=n_agg).astype(float)
    L = _Level(A=None, Dinv=jnp.zeros((n, b, b)),
               cnt_inv=jnp.asarray(1.0 / cnt, jnp.float32),
               n=n, b=b, factor=factor, n_agg=n_agg)
    zc = jnp.asarray(np.random.default_rng(0).standard_normal(n_agg * b),
                     jnp.float32)
    np.testing.assert_allclose(np.asarray(_restrict(L, _prolong(L, zc))),
                               np.asarray(zc), rtol=1e-6)


def test_vcycle_is_exact_on_bottom_level():
    """With no coarsening needed (n <= bottom_max) the PC is the exact dense
    inverse of shift·I + D."""
    model = _wave(4)
    pc = AggregationVCyclePC.from_bsr(model.divergence, shift=1.0,
                                      bottom_max=10**6)
    assert pc.n_levels == 1
    r = jnp.asarray(np.random.default_rng(1).standard_normal(
        model.divergence.shape[0]), jnp.float32)
    x = pc.apply(r)
    Ax = model.implicit_matvec()(x)
    assert float(jnp.linalg.norm(Ax - r) / jnp.linalg.norm(r)) < 1e-3


def test_vcycle_beats_pbjacobi_iterations():
    """On a warped kershaw mesh the
    V-cycle PC must converge in substantially fewer GMRES iterations than
    point-block Jacobi (measured 3DKershawTetra1: 46 vs 180)."""
    model = _wave(8)
    A_op = model.implicit_matvec()
    U0 = model.initial_state()
    it = {}
    for name, M in (
        ("pbjacobi", pcs.pbjacobi(model.divergence, shift=1.0)),
        ("vcycle", AggregationVCyclePC.from_bsr(
            model.divergence, A0_apply=A_op, shift=1.0, factor=4,
            bottom_max=200).apply_partial()),
    ):
        out = make_gmres(A_op, M, rtol=1e-5, atol=1e-5, maxiter=500,
                         side="right")(U0, U0)
        assert bool(out.converged), name
        it[name] = int(out.iters)
    assert it["vcycle"] < 0.6 * it["pbjacobi"], it


def test_vcycle_jits_as_runtime_parameter():
    """The PC pytree must be passable as a jit ARGUMENT (operator payloads
    ride as arguments, never closure constants)."""
    model = _wave(6, tet_mesh)
    pc = AggregationVCyclePC.from_bsr(model.divergence, shift=1.0, factor=4,
                                      bottom_max=100)
    assert pc.n_levels >= 2

    @jax.jit
    def apply(pc_, r):
        return pc_.apply(r)

    r = jnp.asarray(np.random.default_rng(2).standard_normal(
        model.divergence.shape[0]), jnp.float32)
    y1 = apply(pc, r)
    y2 = pc.apply(r)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-5,
                               atol=1e-5)


def test_grid_transfers_partition_of_unity():
    """2×2×2 box mean-restriction of a prolonged coarse vector is the
    identity — including ODD grid dims (truncated boundary boxes)."""
    from circulantpreconditioner_tpu.solvers.aggregation_pc import (
        _GridLevel,
        _grid_prolong,
        _grid_restrict,
    )

    nx, ny, nz, b = 5, 4, 3, 4
    cshape = (3, 2, 2)
    cnt = np.zeros((2, 2, 3))
    for z in range(nz):
        for y in range(ny):
            for x in range(nx):
                cnt[z // 2, y // 2, x // 2] += 1
    L = _GridLevel(A=None, Dinv=jnp.zeros((nx * ny * nz, b, b)),
                   cnt_inv=jnp.asarray((1.0 / cnt)[..., None], jnp.float32),
                   shape_xyz=(nx, ny, nz), cshape_xyz=cshape, b=b)
    zc = jnp.asarray(np.random.default_rng(3).standard_normal(
        int(np.prod(cshape)) * b), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(_grid_restrict(L, _grid_prolong(L, zc))), np.asarray(zc),
        rtol=1e-6)


def test_kershaw_tet_mesh_geometry():
    """The generated 3DKershawTetra analog: warped, volume-exact, hex-major
    supercell numbering."""
    from circulantpreconditioner_tpu.mesh import kershaw_tet_mesh

    m = kershaw_tet_mesh(((0.0, 1.0),) * 3, (5,) * 3)
    assert m.n_cells == 6 * 125
    assert m.cells_per_site == 6 and m.topology_shape == (5, 5, 5)
    assert m.cell_volume.min() > 0
    np.testing.assert_allclose(m.cell_volume.sum(), 1.0, rtol=1e-12)


def test_grid_vcycle_beats_pbjacobi_on_kershaw_tet():
    """On the warped tet supercell mesh — where the cartesian projection PC
    measurably diverges (round-5 negative result) — the geometric-Galerkin
    grid V-cycle must converge in far fewer iterations than pbjacobi
    (measured 12³: 167 vs 588)."""
    from circulantpreconditioner_tpu.mesh import kershaw_tet_mesh
    from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC

    mesh = kershaw_tet_mesh(((0.0, 1.0),) * 3, (8,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
    A_op = model.implicit_matvec()
    U0 = model.initial_state()
    pc = GridVCyclePC.from_grid_model(model.divergence, mesh.topology_shape,
                                      cells_per_site=6, A0_apply=A_op,
                                      shift=1.0, bottom_max=100)
    assert pc.n_levels >= 3
    it = {}
    for name, M in (("pbjacobi", pcs.pbjacobi(model.divergence, shift=1.0)),
                    ("grid", pc.apply_partial())):
        out = make_gmres(A_op, M, rtol=1e-5, atol=1e-5, maxiter=1000,
                         side="right")(U0, U0)
        assert bool(out.converged), name
        it[name] = int(out.iters)
    assert it["grid"] < 0.55 * it["pbjacobi"], it


def test_grid_vcycle_fm_matches_cell_major():
    """apply_fm (zero-relayout field-major form) must equal apply up to
    dtype roundoff, on both a supercell tet mesh and a cps=1 kershaw."""
    from circulantpreconditioner_tpu.mesh import kershaw_mesh, kershaw_tet_mesh
    from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC

    for mesh_fn, cps in ((kershaw_tet_mesh, 6), (kershaw_mesh, 1)):
        mesh = mesh_fn(((0.0, 1.0),) * 3, (6,) * 3)
        model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
        pc = GridVCyclePC.from_grid_model(model.divergence, mesh.topology_shape,
                                          cells_per_site=cps, shift=1.0,
                                          bottom_max=30)
        r_cm = jnp.asarray(np.random.default_rng(5).standard_normal(
            model.divergence.shape[0]).astype(np.float32))
        z_cm = np.asarray(pc.apply(r_cm))
        g = model.pack_fm(np.asarray(r_cm)).reshape(-1)
        z_fm = np.asarray(pc.apply_fm(g))
        z_fm_cm = np.asarray(model.unpack_fm(
            z_fm.reshape(model.fm_block, -1))).reshape(-1)
        np.testing.assert_allclose(z_fm_cm, z_cm, rtol=2e-4, atol=2e-4)


def test_grid_vcycle_scalar_transport():
    """b=1 grid V-cycle on the scalar transport operator (the reference
    PCSHELL's target equation) — fewer GMRES iterations than PCNONE on a
    warped kershaw mesh."""
    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.models import TransportEquation
    from circulantpreconditioner_tpu.ops.csr import BSRMatrix
    from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC

    mesh = kershaw_mesh(((0.0, 1.0),) * 3, (8,) * 3)
    model = TransportEquation(mesh, velocity=[1.0, 0.0, 0.0], cfl=1e3 / 3,
                              dtype=jnp.float32)
    A_op = model.implicit_matvec()
    u0 = model.initial_state()
    D = model.divergence
    sp_ = D.to_scipy().tocoo()
    Db = BSRMatrix.from_block_coo(D.shape[0], D.shape[1], sp_.row, sp_.col,
                                  sp_.data.reshape(-1, 1, 1),
                                  dtype=jnp.float32)
    pc = GridVCyclePC.from_grid_model(Db, mesh.topology_shape,
                                      cells_per_site=1, A0_apply=A_op,
                                      shift=1.0, bottom_max=100)
    it = {}
    for name, M, side in (("none", None, "left"),
                          ("gridmg", pc.apply_partial(), "right")):
        out = make_gmres(A_op, M, rtol=1e-5, atol=1e-5, maxiter=500,
                         side=side)(u0, u0)
        assert bool(out.converged), name
        it[name] = int(out.iters)
    assert it["gridmg"] < 0.7 * it["none"], it
