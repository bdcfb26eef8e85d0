"""Distributed (8 virtual CPU devices) tests: slab FFT solve, sharded SpMV,
and sharded GMRES — the multi-chip code paths exercised the way the
reference exercises MPI with mpiexec -n 2/4 (tests/CMakeLists.txt:67-74)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from circulantpreconditioner_tpu.mesh import cartesian_mesh
from circulantpreconditioner_tpu.models import TransportEquation, WaveSystem
from circulantpreconditioner_tpu.ops.circulant import CirculantTransportOperator
from circulantpreconditioner_tpu.ops.csr import CSRMatrix
from circulantpreconditioner_tpu.parallel import (
    ShardedELLMatrix,
    SlabCirculantSolver,
    device_mesh,
)
from circulantpreconditioner_tpu.parallel.fft_dist import make_distributed_fft3
from circulantpreconditioner_tpu.solvers import make_gmres

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs >=2 devices")


def test_distributed_fft3_matches_fftn():
    mesh = device_mesh(8)
    rng = np.random.default_rng(0)
    v = rng.random((8, 8, 4)) + 1j * rng.random((8, 8, 4))
    fwd = make_distributed_fft3(mesh)
    inv = make_distributed_fft3(mesh, inverse=True)
    got = np.asarray(fwd(jnp.asarray(v)))
    np.testing.assert_allclose(got, np.fft.fftn(v), atol=1e-10)
    back = np.asarray(inv(jnp.asarray(got)))
    np.testing.assert_allclose(back, v, atol=1e-10)


def test_slab_circulant_solver_matches_single_device():
    mesh = device_mesh(8)
    shape = (16, 8, 12)  # nz, ny, nx — nz,ny divisible by 8
    lams = (0.3, 0.8, 2.0)
    op = CirculantTransportOperator.create(shape, lams, jnp.float64)
    solver = SlabCirculantSolver.from_operator(op, mesh)
    rng = np.random.default_rng(1)
    b = rng.random(shape)
    x_ref = np.asarray(op.solve(jnp.asarray(b)))
    x = np.asarray(solver.solve(solver.shard(b)))
    np.testing.assert_allclose(x, x_ref, atol=1e-10)


def test_sharded_spmv_matches_local():
    mesh = device_mesh(8)
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (9, 7))  # 63 rows → padding path
    model = WaveSystem(m, cfl=100.0, dtype=jnp.float64)
    A = model.divergence.to_csr(jnp.float64)
    As = ShardedELLMatrix(A, mesh)
    rng = np.random.default_rng(2)
    x = rng.random(A.shape[1])
    y_ref = np.asarray(A.matvec(jnp.asarray(x)))
    y = As.unshard_vector(As.matvec(As.shard_vector(x)))
    np.testing.assert_allclose(y, y_ref, atol=1e-10)


def test_sharded_gmres_wave_implicit():
    """Full sharded implicit wave solve: GMRES over sharded vectors with the
    distributed SpMV; compares to the single-device GMRES solution."""
    mesh = device_mesh(8)
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (8, 8))
    model = WaveSystem(m, cfl=1e3 / 2, dtype=jnp.float64)
    A = model.divergence.to_csr(jnp.float64)
    U0 = np.asarray(model.initial_state())

    As = ShardedELLMatrix(A, mesh)

    def A_dist(x):
        return x + As.matvec(x)

    solver = make_gmres(A_dist, rtol=1e-10, atol=1e-12, maxiter=500)
    b = As.shard_vector(U0)
    res = jax.jit(solver)(b, b)
    x_dist = As.unshard_vector(res.x)

    def A_loc(x):
        return x + A.matvec(x)

    res_ref = make_gmres(A_loc, rtol=1e-10, atol=1e-12, maxiter=500)(jnp.asarray(U0), jnp.asarray(U0))
    assert bool(res.converged) and bool(res_ref.converged)
    np.testing.assert_allclose(x_dist, np.asarray(res_ref.x), rtol=1e-6, atol=1e-6)


def test_distributed_transport_fft_step_matches_local():
    """One implicit FFT transport step on a 3D periodic grid, slab-sharded,
    equals the single-device fft_stepper result."""
    mesh = device_mesh(8)
    n = (8, 8, 16)  # nx, ny, nz
    m = cartesian_mesh(((-0.5, 0.5),) * 3, n, periodic=True)
    model = TransportEquation(m, velocity=[1.0, 0.0, 0.0], cfl=1e3 / 3, dtype=jnp.float64)
    u0 = model.initial_state()
    u1_ref, _ = model.fft_stepper()(u0)

    solver = SlabCirculantSolver.from_operator(model.fft_operator, mesh)
    shape_zyx = model.fft_operator.shape_zyx
    b = solver.shard(np.asarray(u0).reshape(shape_zyx))
    u1 = np.asarray(solver.solve(b)).reshape(-1)
    np.testing.assert_allclose(u1, np.asarray(u1_ref), atol=1e-10)


def test_halo_spmv_matches_allgather():
    """ppermute halo SpMV == all-gather SpMV == single-device SpMV on the
    lexicographically ordered wave operator (bandwidth fits one row block)."""
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix

    mesh = device_mesh(8)
    m = cartesian_mesh(((-0.5, 0.5),) * 3, (4, 4, 16))
    model = WaveSystem(m, cfl=100.0, dtype=jnp.float64)
    A = model.divergence.to_csr(jnp.float64)
    Ah = HaloELLMatrix(A, mesh)
    Ag = ShardedELLMatrix(A, mesh)
    rng = np.random.default_rng(5)
    x = rng.random(A.shape[1])
    y_ref = np.asarray(A.matvec(jnp.asarray(x)))
    y_h = Ah.unshard_vector(Ah.matvec(Ah.shard_vector(x)))
    y_g = Ag.unshard_vector(Ag.matvec(Ag.shard_vector(x)))
    np.testing.assert_allclose(y_h, y_ref, atol=1e-10)
    np.testing.assert_allclose(y_g, y_ref, atol=1e-10)


def test_halo_spmv_rejects_wide_band():
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix

    mesh = device_mesh(8)
    # periodic wrap gives bandwidth ~ n — must be rejected cleanly
    m = cartesian_mesh(((-0.5, 0.5),) * 1, (64,), periodic=True)
    from circulantpreconditioner_tpu.models import TransportEquation

    model = TransportEquation(m, velocity=[1.0], cfl=10.0, dtype=jnp.float64)
    with pytest.raises(ValueError, match="bandwidth"):
        HaloELLMatrix(model.divergence, mesh)


def test_halo_spmv_in_gmres():
    """Distributed implicit wave GMRES with the halo SpMV matches local."""
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix

    mesh = device_mesh(8)
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (6, 16))
    model = WaveSystem(m, cfl=200.0, dtype=jnp.float64)
    A = model.divergence.to_csr(jnp.float64)
    Ah = HaloELLMatrix(A, mesh)
    U0 = np.asarray(model.initial_state())

    import jax as _jax

    def A_dist(x):
        return x + Ah.matvec(x)

    solver = make_gmres(A_dist, rtol=1e-10, atol=1e-12, maxiter=500)
    b = Ah.shard_vector(U0)
    res = solver(b, b)
    x_dist = Ah.unshard_vector(res.x)
    res_ref = make_gmres(model.implicit_matvec(), rtol=1e-10, atol=1e-12, maxiter=500)(
        jnp.asarray(U0), jnp.asarray(U0))
    assert bool(res.converged) and bool(res_ref.converged)
    np.testing.assert_allclose(x_dist, np.asarray(res_ref.x), rtol=1e-6, atol=1e-6)


def test_pencil_circulant_solver_matches_single_device():
    """Pencil (2D device mesh) distributed solve == replicated solve, on both
    mesh orientations and with an odd-padding x half-spectrum."""
    from circulantpreconditioner_tpu.parallel import PencilCirculantSolver, device_mesh_2d

    rng = np.random.default_rng(3)
    for pq in ((4, 2), (2, 4)):
        mesh = device_mesh_2d(pq)
        for shape in ((8, 8, 6), (8, 8, 7)):  # nxr = 4 and 4 (odd nx too)
            op = CirculantTransportOperator.create(shape, (0.4, -0.3, 5.0), jnp.float64)
            solver = PencilCirculantSolver.from_operator(op, mesh)
            b = rng.random(shape)
            x = solver.solve(solver.shard(jnp.asarray(b)))
            x_ref = op.solve(jnp.asarray(b))
            np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), atol=1e-12)
            # and it actually solves: residual through the operator matvec
            r = np.asarray(op.matvec(jnp.asarray(np.asarray(x)))) - b
            assert np.abs(r).max() < 1e-10


def test_slab_stencil_spmv_matches_local():
    """z-slab-sharded varying-stencil SpMV (ppermute halo) == single-device
    matvec, on wall (Kershaw) and periodic meshes, scalar and block."""
    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.models import TransportEquation, WaveSystem
    from circulantpreconditioner_tpu.ops.stencil import VaryingStencilOperator
    from circulantpreconditioner_tpu.parallel import SlabStencilOperator

    mesh = device_mesh(8)
    rng = np.random.default_rng(0)

    m = kershaw_mesh(((0.0, 1.0),) * 3, (4, 3, 8))  # nz=8 over 8 devices
    w = WaveSystem(m, cfl=10.0, dtype=jnp.float64)
    V = VaryingStencilOperator.from_bsr(w.divergence, m.topology_shape)
    assert V.layout == "flat"
    S = SlabStencilOperator(V, mesh)
    x = rng.random(m.n_cells * 4)
    y = S.unshard_vector(S.matvec(S.shard_vector(x)))
    np.testing.assert_allclose(y, np.asarray(V.matvec(jnp.asarray(x))), atol=1e-12)

    m2 = kershaw_mesh(((0.0, 1.0),) * 3, (4, 4, 8))
    m2.set_periodic()
    t2 = TransportEquation(m2, velocity=[1.0, 0.5, -0.2], cfl=3.0, dtype=jnp.float64)
    V2 = VaryingStencilOperator.from_csr(t2.divergence, m2.topology_shape)
    assert V2.layout == "grid_last"  # periodic wrap needs per-axis rolls
    S2 = SlabStencilOperator(V2, mesh)
    x2 = rng.random(m2.n_cells)
    y2 = S2.unshard_vector(S2.matvec(S2.shard_vector(x2)))
    np.testing.assert_allclose(y2, np.asarray(V2.matvec(jnp.asarray(x2))), atol=1e-13)


def test_slab_stencil_in_sharded_gmres():
    """Implicit wave GMRES over the slab-sharded stencil operator."""
    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.models import WaveSystem
    from circulantpreconditioner_tpu.ops.stencil import VaryingStencilOperator
    from circulantpreconditioner_tpu.parallel import SlabStencilOperator
    from circulantpreconditioner_tpu.solvers import make_gmres

    mesh = device_mesh(8)
    m = kershaw_mesh(((0.0, 1.0),) * 3, (4, 4, 8))
    w = WaveSystem(m, cfl=50.0, dtype=jnp.float64)
    V = VaryingStencilOperator.from_bsr(w.divergence, m.topology_shape)
    S = SlabStencilOperator(V, mesh)

    g4 = (8, 4, 4, 4)  # (nz, ny, nx, m)

    def A(v):
        v4 = v.reshape(g4)
        return (v4 + S.matvec(v4)).reshape(-1)

    solver = make_gmres(A, rtol=1e-8, atol=1e-10, maxiter=500)
    b = S.shard_vector(np.asarray(w.initial_state())).reshape(-1)
    res = solver(b, b)
    assert bool(np.asarray(res.converged))
    x = np.asarray(res.x)
    r = np.asarray(w.divergence.matvec(jnp.asarray(x))) + x - np.asarray(w.initial_state())
    assert np.abs(r).max() / np.abs(x).max() < 1e-7


# ---------------------------------------------------------------------------
# Distributed PRECONDITIONED solves — the reference's actual MPI workload
# (GMRES+BJACOBI distributed, WaveSystem_..._impl_mpi.cxx:32-34,139-189) and
# its end-goal (FFT PC inside parallel KSP, ToDo.md:1, PCSHELLFft_3D.cxx).
# ---------------------------------------------------------------------------


def test_slab_block_circulant_solver_matches_single_device():
    from circulantpreconditioner_tpu.ops.assembly import wave_block_stencil
    from circulantpreconditioner_tpu.ops.circulant import BlockCirculantOperator
    from circulantpreconditioner_tpu.parallel.pc_dist import SlabBlockCirculantSolver

    mesh = device_mesh(8)
    shape_zyx = (8, 8, 6)
    offsets, blocks = wave_block_stencil(3, 0.01, 700.0, (1 / 6, 1 / 8, 1 / 8))
    ref = BlockCirculantOperator.from_stencil(shape_zyx, offsets, blocks, jnp.float64)
    slab = SlabBlockCirculantSolver.from_stencil(
        shape_zyx, offsets, blocks, mesh, dtype=jnp.float64, precision="highest")
    rng = np.random.default_rng(7)
    b = rng.random(8 * 8 * 6 * 4)
    x_ref = np.asarray(ref.solve(jnp.asarray(b)))
    x = np.asarray(slab.solve(slab.shard(b))).reshape(-1)
    np.testing.assert_allclose(x, x_ref, atol=1e-10)


def test_sharded_pbjacobi_matches_local():
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix
    from circulantpreconditioner_tpu.parallel.pc_dist import sharded_pbjacobi
    from circulantpreconditioner_tpu.solvers import preconditioners as pcs

    mesh = device_mesh(8)
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (6, 16))
    model = WaveSystem(m, cfl=200.0, dtype=jnp.float64)
    D = model.divergence
    b = D.block_size
    Ah = HaloELLMatrix(D.to_csr(jnp.float64), mesh, row_multiple=b)
    assert Ah.n_padded % (8 * b) == 0
    Dinv = np.linalg.inv(
        np.asarray(D.block_diagonal()) + np.eye(b)[None, :, :])
    M_dist = sharded_pbjacobi(Dinv, Ah.n_padded, mesh, dtype=jnp.float64)
    M_loc = pcs.pbjacobi(D, shift=1.0)
    rng = np.random.default_rng(8)
    r = rng.random(D.shape[0])
    z_ref = np.asarray(M_loc(jnp.asarray(r)))
    z = Ah.unshard_vector(M_dist(Ah.shard_vector(r)))
    np.testing.assert_allclose(z, z_ref, atol=1e-12)


def test_sharded_gmres_pbjacobi_matches_single_device():
    """GMRES + point-block-Jacobi PC distributed == single device: same
    iteration count, same solution (the impl_mpi GMRES+BJACOBI analog)."""
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix
    from circulantpreconditioner_tpu.parallel.pc_dist import sharded_pbjacobi
    from circulantpreconditioner_tpu.solvers import preconditioners as pcs

    mesh = device_mesh(8)
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (8, 16))
    # cfl=100: restart-30 GMRES+pbjacobi converges at rtol 1e-8 in ~200 its
    # (the reference's cfl=1e3/dim needs its looser 1e-5 tolerance)
    model = WaveSystem(m, cfl=100.0, dtype=jnp.float64)
    D = model.divergence
    b = D.block_size
    A = D.to_csr(jnp.float64)
    U0 = np.asarray(model.initial_state())

    Ah = HaloELLMatrix(A, mesh, row_multiple=b)
    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()) + np.eye(b)[None, :, :])
    M_dist = sharded_pbjacobi(Dinv, Ah.n_padded, mesh, dtype=jnp.float64)

    def A_dist(x):
        return x + Ah.matvec(x)

    sol_d = make_gmres(A_dist, M_dist, rtol=1e-8, atol=1e-10, maxiter=500)
    bb = Ah.shard_vector(U0)
    res_d = sol_d(bb, bb)

    M_loc = pcs.pbjacobi(D, shift=1.0)
    sol_l = make_gmres(lambda x: x + A.matvec(x), M_loc,
                       rtol=1e-8, atol=1e-10, maxiter=500)
    res_l = sol_l(jnp.asarray(U0), jnp.asarray(U0))
    assert bool(res_d.converged) and bool(res_l.converged)
    assert int(res_d.iters) == int(res_l.iters)
    np.testing.assert_allclose(Ah.unshard_vector(res_d.x), np.asarray(res_l.x),
                               rtol=1e-6, atol=1e-8)


def test_distributed_block_circulant_pc_matches_single_device():
    """The distributed projection PC apply == the single-device
    BlockCirculantProjectionPC apply (same derived grid: kershaw 8^3 ->
    512 cells -> 8x8x8 cartesian grid, already divisible by P=8)."""
    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix
    from circulantpreconditioner_tpu.parallel.pc_dist import DistributedBlockCirculantPC
    from circulantpreconditioner_tpu.solvers.circulant_pc import (
        BlockCirculantProjectionPC,
    )

    mesh = device_mesh(8)
    km = kershaw_mesh(((0.0, 1.0),) * 3, (8, 8, 8))
    model = WaveSystem(km, cfl=333.0, dtype=jnp.float64)
    D = model.divergence
    Ah = HaloELLMatrix(D.to_csr(jnp.float64), mesh, row_multiple=4)

    pc_d = DistributedBlockCirculantPC(km, model.dt, model.c0, mesh,
                                       Ah.n_padded, dtype=jnp.float64,
                                       precision="highest")
    assert pc_d.n_xyz == (8, 8, 8)
    pc_l = BlockCirculantProjectionPC(km, model.dt, model.c0, dtype=jnp.float64,
                                      method="fft")
    rng = np.random.default_rng(9)
    r = rng.random(D.shape[0])
    z_ref = np.asarray(pc_l(jnp.asarray(r)))
    z = Ah.unshard_vector(pc_d.apply(Ah.shard_vector(r)))
    np.testing.assert_allclose(z, z_ref, rtol=1e-8, atol=1e-10)


def test_sharded_gmres_circulant2l_matches_single_device():
    """THE flagship composition: distributed GMRES with the additive
    two-level (block-circulant projection + pbjacobi) right PC equals the
    single-device solve in iterations and solution."""
    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix
    from circulantpreconditioner_tpu.parallel.pc_dist import (
        DistributedBlockCirculantPC,
        sharded_pbjacobi,
    )
    from circulantpreconditioner_tpu.solvers import preconditioners as pcs
    from circulantpreconditioner_tpu.solvers.circulant_pc import (
        BlockCirculantProjectionPC,
    )

    mesh = device_mesh(8)
    km = kershaw_mesh(((0.0, 1.0),) * 3, (8, 8, 8))
    model = WaveSystem(km, cfl=333.0, dtype=jnp.float64)
    D = model.divergence
    A = D.to_csr(jnp.float64)
    U0 = np.asarray(model.initial_state())
    b = D.block_size

    Ah = HaloELLMatrix(A, mesh, row_multiple=b)
    coarse_d = DistributedBlockCirculantPC(km, model.dt, model.c0, mesh,
                                           Ah.n_padded, dtype=jnp.float64,
                                           precision="highest")
    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()) + np.eye(b)[None, :, :])
    M_d = pcs.additive(coarse_d.apply,
                       sharded_pbjacobi(Dinv, Ah.n_padded, mesh, dtype=jnp.float64))

    sol_d = make_gmres(lambda x: x + Ah.matvec(x), M_d, rtol=1e-8, atol=1e-10,
                       maxiter=500, side="right")
    bb = Ah.shard_vector(U0)
    res_d = sol_d(bb, bb)

    coarse_l = BlockCirculantProjectionPC(km, model.dt, model.c0,
                                          dtype=jnp.float64, method="fft")
    M_l = pcs.additive(coarse_l.apply, pcs.pbjacobi(D, shift=1.0))
    sol_l = make_gmres(lambda x: x + A.matvec(x), M_l, rtol=1e-8, atol=1e-10,
                       maxiter=500, side="right")
    res_l = sol_l(jnp.asarray(U0), jnp.asarray(U0))

    assert bool(res_d.converged) and bool(res_l.converged)
    assert int(res_d.iters) == int(res_l.iters)
    # the PC accelerates: strictly fewer iterations than unpreconditioned
    res_p = make_gmres(lambda x: x + A.matvec(x), rtol=1e-8, atol=1e-10,
                       maxiter=500)(jnp.asarray(U0), jnp.asarray(U0))
    assert int(res_l.iters) < int(res_p.iters)
    np.testing.assert_allclose(Ah.unshard_vector(res_d.x), np.asarray(res_l.x),
                               rtol=1e-6, atol=1e-8)


def test_halo_spmv_compiled_hlo_uses_ppermute_not_allgather():
    """Lock in the communication pattern: the compiled halo SpMV contains
    collective-permute(s) and NO all-gather (a regression to all-gather would
    be silent otherwise — VecScatter-inside-MatMult parity, SURVEY §2.6)."""
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix

    mesh = device_mesh(8)
    m = cartesian_mesh(((-0.5, 0.5),) * 2, (6, 16))
    model = WaveSystem(m, cfl=200.0, dtype=jnp.float64)
    Ah = HaloELLMatrix(model.divergence.to_csr(jnp.float64), mesh)
    x = Ah.shard_vector(np.zeros(Ah.n))
    hlo = jax.jit(Ah._spmv).lower(Ah.cols, Ah.vals, x).compile().as_text()
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo


def test_distributed_pc_halo_matches_allgather():
    """The personalized-exchange (halo) PC apply == the replicating
    all_gather formulation, bit-for-bit up to summation order."""
    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix
    from circulantpreconditioner_tpu.parallel.pc_dist import DistributedBlockCirculantPC

    mesh = device_mesh(8)
    km = kershaw_mesh(((0.0, 1.0),) * 3, (8, 8, 8))
    model = WaveSystem(km, cfl=333.0, dtype=jnp.float64)
    Ah = HaloELLMatrix(model.divergence.to_csr(jnp.float64), mesh, row_multiple=4)
    pc_h = DistributedBlockCirculantPC(km, model.dt, model.c0, mesh,
                                       Ah.n_padded, dtype=jnp.float64,
                                       precision="highest", halo=True)
    pc_g = DistributedBlockCirculantPC(km, model.dt, model.c0, mesh,
                                       Ah.n_padded, dtype=jnp.float64,
                                       precision="highest", halo=False)
    rng = np.random.default_rng(11)
    r = Ah.shard_vector(rng.random(model.divergence.shape[0]))
    z_h = Ah.unshard_vector(pc_h.apply(r))
    z_g = Ah.unshard_vector(pc_g.apply(r))
    np.testing.assert_allclose(z_h, z_g, rtol=1e-13, atol=1e-13)


def test_distributed_pc_compiled_hlo_uses_all_to_all_not_allgather():
    """Lock in the PC apply's communication pattern: personalized
    all_to_all exchanges (+ the slab solver's y<->z transpose pair), NO
    all-gather — a silent regression to vector replication would otherwise
    be invisible (VecScatter parity, SURVEY 2.6)."""
    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix
    from circulantpreconditioner_tpu.parallel.pc_dist import DistributedBlockCirculantPC

    mesh = device_mesh(8)
    km = kershaw_mesh(((0.0, 1.0),) * 3, (8, 8, 8))
    model = WaveSystem(km, cfl=333.0, dtype=jnp.float64)
    Ah = HaloELLMatrix(model.divergence.to_csr(jnp.float64), mesh, row_multiple=4)
    pc = DistributedBlockCirculantPC(km, model.dt, model.c0, mesh,
                                     Ah.n_padded, dtype=jnp.float64)
    r = Ah.shard_vector(np.zeros(model.divergence.shape[0]))
    hlo = jax.jit(pc.apply).lower(r).compile().as_text()
    assert "all-to-all" in hlo
    assert "all-gather" not in hlo


def test_halo_window_spmv_matches_single_device():
    """Row-sharded clustered-window SpMV (parallel/window_dist.py) — the
    distributed unstructured MatMult for the tetra fixture families — equals
    the single-device windowed apply and the assembled BSR on a RANDOM banded
    block matrix (RCM-ordered-mesh stand-in)."""
    from circulantpreconditioner_tpu.ops.csr import BSRMatrix
    from circulantpreconditioner_tpu.ops.window_spmv import WindowedBlockOperator
    from circulantpreconditioner_tpu.parallel import HaloWindowOperator

    mesh = device_mesh(8)
    rng = np.random.default_rng(11)
    n, b = 203, 4  # not a multiple of anything convenient
    rows, cols = [], []
    for i in range(n):
        for j in np.unique(np.clip(i + rng.integers(-6, 7, 4), 0, n - 1)):
            rows.append(i)
            cols.append(int(j))
    blocks = rng.standard_normal((len(rows), b, b))
    A = BSRMatrix.from_block_coo(n, n, np.asarray(rows), np.asarray(cols),
                                 blocks, dtype=jnp.float64)
    W = WindowedBlockOperator.from_bsr(A, G=8, unit=2)
    H = HaloWindowOperator(W, mesh)
    x = rng.standard_normal(n * b)
    y_ref = np.asarray(A.matvec(jnp.asarray(x)))
    y1 = np.asarray(W.matvec(jnp.asarray(x)))
    y2 = H.unshard_vector(H.matvec(H.shard_vector(x)))
    np.testing.assert_allclose(y1, y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y2, y_ref, rtol=1e-12, atol=1e-12)
    assert H.halo_units > 0  # the band genuinely crosses shard boundaries


def test_halo_window_gmres_on_fixture_mesh():
    """Sharded GMRES whose SpMV is the halo windowed operator, on the
    reference's own meshCube.med (the mesh its MPI drivers are registered
    with) — iteration count and solution must match the single-device
    solve."""
    import os

    if not os.path.isdir("/root/reference/meshes"):
        pytest.skip("reference mesh fixtures not available")
    from circulantpreconditioner_tpu.mesh import read_mesh
    from circulantpreconditioner_tpu.ops.window_spmv import WindowedBlockOperator
    from circulantpreconditioner_tpu.parallel import HaloWindowOperator

    mesh = device_mesh(8)
    m = read_mesh("/root/reference/meshes/meshCube.med")
    assert getattr(m, "bandwidth_ordered", False)
    model = WaveSystem(m, cfl=100.0, dtype=jnp.float64)
    A = model.divergence
    W = WindowedBlockOperator.from_bsr(A, G=8, unit=2)
    H = HaloWindowOperator(W, mesh)
    b = np.asarray(model.initial_state(), dtype=np.float64)

    Aop = jax.tree_util.Partial(lambda sp, x: x + sp(x), H.matvec_partial())
    sol_d = make_gmres(Aop, rtol=1e-8, atol=1e-10, maxiter=500)
    bb = H.shard_vector(b)
    res_d = sol_d(bb, bb)

    sol_l = make_gmres(model.implicit_matvec(), rtol=1e-8, atol=1e-10,
                       maxiter=500)
    res_l = sol_l(jnp.asarray(b), jnp.asarray(b))
    assert bool(res_d.converged) and bool(res_l.converged)
    assert int(res_d.iters) == int(res_l.iters)
    np.testing.assert_allclose(H.unshard_vector(res_d.x),
                               np.asarray(res_l.x), rtol=1e-6, atol=1e-8)
