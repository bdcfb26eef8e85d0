"""Worker process for the multi-host simulation test (NOT a pytest module).

Usage: python multihost_worker.py <pid> <nprocs> <port>
Run with JAX_PLATFORMS=cpu. Each process
contributes 2 virtual CPU devices; together they form the 'cluster' exactly
as the reference simulates multi-node with mpiexec -n 2
(/root/reference/tests/CMakeLists.txt:67-74).
"""

import sys

import numpy as np


def main():
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    stage = sys.argv[4] if len(sys.argv) > 4 else "slab"

    from circulantpreconditioner_tpu.parallel.multihost import (
        gather_to_host0,
        global_device_mesh,
        init_multihost,
    )

    init_multihost(f"localhost:{port}", nprocs, pid, local_device_count=2)
    if stage == "pcgmres":
        return pcgmres_stage()
    if stage == "window":
        return window_stage()

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert len(jax.devices()) == 2 * nprocs, jax.devices()

    from circulantpreconditioner_tpu.ops.circulant import (
        CirculantTransportOperator,
        np_eigenvalue_diagonal,
    )
    from circulantpreconditioner_tpu.parallel import SlabCirculantSolver

    shape = (8, 8, 6)
    lambdas = (0.4, -0.3, 5.0)
    mesh = global_device_mesh()
    op = CirculantTransportOperator.create(shape, lambdas, jnp.float64)
    solver = SlabCirculantSolver.from_operator(op, mesh)

    # same deterministic global data on every process
    b = np.random.default_rng(0).random(shape)
    gb = jax.make_array_from_callback(
        shape, NamedSharding(mesh, P("shard", None, None)), lambda idx: b[idx]
    )
    x = solver.solve(gb)
    jax.block_until_ready(x)

    x0 = gather_to_host0(x)  # VecScatterCreateToZero analog
    if jax.process_index() == 0:
        lam = np_eigenvalue_diagonal(shape, lambdas, rfft=True)
        x_ref = np.fft.irfftn(np.fft.rfftn(b) / lam, s=shape)
        err = np.abs(x0 - x_ref).max()
        assert err < 1e-12, f"multihost solve mismatch: {err}"
        print(f"OK process0 err={err:.3e}", flush=True)
    jax.distributed.shutdown()


def _implicit_op(spmv, x):
    """(I + D)·x with the SpMV bound as a Partial leaf (jit argument)."""
    return x + spmv(x)


def pcgmres_stage():
    """Preconditioned sharded GMRES across the 2-process cluster — the
    mpiexec -n 2 analog of the reference's implicit MPI driver
    (WaveSystem_SphericalExplosion_impl_mpi.cxx:32-34,139-189) composed with
    the distributed two-level circulant PC (the reference's stated end-goal,
    ToDo.md:1). Asserts iteration-count and solution parity against the
    single-process two-level solve on process 0."""
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.models import WaveSystem
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix
    from circulantpreconditioner_tpu.parallel.multihost import (
        gather_to_host0,
        global_device_mesh,
    )
    from circulantpreconditioner_tpu.parallel.pc_dist import (
        DistributedBlockCirculantPC,
        sharded_pbjacobi,
    )
    from circulantpreconditioner_tpu.solvers import make_gmres, preconditioners as pcs

    mesh = global_device_mesh()  # 4 devices spanning 2 processes
    km = kershaw_mesh(((0.0, 1.0),) * 3, (8, 8, 8))
    model = WaveSystem(km, cfl=333.0, dtype=jnp.float64)
    D = model.divergence
    b = D.block_size
    A = D.to_csr(jnp.float64)
    U0 = np.asarray(model.initial_state())

    Ah = HaloELLMatrix(A, mesh, row_multiple=b)
    coarse = DistributedBlockCirculantPC(km, model.dt, model.c0, mesh,
                                         Ah.n_padded, dtype=jnp.float64,
                                         precision="highest")
    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()) + np.eye(b)[None, :, :])
    M = pcs.additive(coarse.apply,
                     sharded_pbjacobi(Dinv, Ah.n_padded, mesh, dtype=jnp.float64))
    # Multi-process rule: global arrays may only enter jit as ARGUMENTS, so
    # the operator and PC must be Partial pytrees, never closures.
    Aop = jax.tree_util.Partial(_implicit_op, Ah.matvec_partial())
    sol = make_gmres(Aop, M, rtol=1e-8, atol=1e-10, maxiter=500, side="right")
    bb = Ah.shard_vector(U0)
    res = sol(bb, bb)
    import jax as _j
    _j.block_until_ready(res.x)
    iters_d = int(np.asarray(res.iters))
    conv_d = bool(np.asarray(res.converged))
    x0 = gather_to_host0(res.x)

    if jax.process_index() == 0:
        from circulantpreconditioner_tpu.solvers.circulant_pc import (
            BlockCirculantProjectionPC,
        )

        coarse_l = BlockCirculantProjectionPC(km, model.dt, model.c0,
                                              dtype=jnp.float64,
                                              method="fft")
        M_l = pcs.additive(coarse_l.apply, pcs.pbjacobi(D, shift=1.0))
        sol_l = make_gmres(lambda x: x + A.matvec(x), M_l, rtol=1e-8,
                           atol=1e-10, maxiter=500, side="right")
        res_l = sol_l(jnp.asarray(U0), jnp.asarray(U0))
        assert conv_d and bool(res_l.converged)
        assert iters_d == int(res_l.iters), (iters_d, int(res_l.iters))
        err = np.abs(x0[: A.shape[0]] - np.asarray(res_l.x)).max()
        scale = np.abs(np.asarray(res_l.x)).max()
        assert err < 1e-6 * scale, f"solution mismatch: {err} vs scale {scale}"
        print(f"OK process0 pcgmres iters={iters_d} err={err:.3e}", flush=True)
    jax.distributed.shutdown()


def window_stage():
    """Halo clustered-window SpMV GMRES across the real process cluster —
    the UNSTRUCTURED-mesh analog of pcgmres_stage, on a generated tetra
    mesh with its grid numbering dropped and RCM-ordered, like the
    reference's tetra fixtures are at load. Mirrors the reference's MPI
    drivers on meshCube.med (tests/CMakeLists.txt:67-74): row-block layout,
    one-neighbour unit-halo ghost update (ppermute), parallel Krylov
    reductions. Asserts iteration and solution parity vs the single-process
    windowed solve on process 0."""
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh.topology import renumber_bandwidth
    from circulantpreconditioner_tpu.mesh.unstructured import tet_mesh
    from circulantpreconditioner_tpu.models import WaveSystem
    from circulantpreconditioner_tpu.ops.window_spmv import WindowedBlockOperator
    from circulantpreconditioner_tpu.parallel.multihost import (
        gather_to_host0,
        global_device_mesh,
    )
    from circulantpreconditioner_tpu.parallel.pc_dist import sharded_pbjacobi
    from circulantpreconditioner_tpu.parallel.window_dist import HaloWindowOperator
    from circulantpreconditioner_tpu.solvers import make_gmres, preconditioners as pcs

    mesh = global_device_mesh()
    # 1,764 tets (the size of the reference's mesh_tetra_1): large enough
    # that the RCM unit-halo fits the 8-way device block of the n=4 tier
    km = tet_mesh(((0.0, 1.0),) * 3, (7, 7, 6))
    km.topology_shape = None  # type: ignore[attr-defined]
    km.cells_per_site = 1  # type: ignore[attr-defined]
    assert renumber_bandwidth(km)
    # cfl 10: pbjacobi-GMRES converges in ~60 iterations on this mesh (at
    # the fixture's cfl 333 it stalls past 500)
    model = WaveSystem(km, cfl=10.0, dtype=jnp.float64)
    D = model.divergence
    b = D.block_size
    W = WindowedBlockOperator.from_bsr(D, dtype=jnp.float64)
    Ah = HaloWindowOperator(W, mesh)
    U0 = np.asarray(model.initial_state())

    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()) + np.eye(b)[None, :, :])
    M = sharded_pbjacobi(Dinv, Ah.n_padded, mesh, dtype=jnp.float64)
    Aop = jax.tree_util.Partial(_implicit_op, Ah.matvec_partial())
    sol = make_gmres(Aop, M, rtol=1e-8, atol=1e-10, maxiter=500, side="right")
    bb = Ah.shard_vector(np.concatenate(
        [U0, np.zeros(Ah.n_padded - U0.shape[0])]))
    res = sol(bb, bb)
    jax.block_until_ready(res.x)
    iters_d = int(np.asarray(res.iters))
    conv_d = bool(np.asarray(res.converged))
    x0 = gather_to_host0(res.x)

    import jax as _j
    if _j.process_index() == 0:
        M_l = pcs.pbjacobi(D, shift=1.0)
        sol_l = make_gmres(
            jax.tree_util.Partial(_implicit_op, W.matvec_partial()), M_l,
            rtol=1e-8, atol=1e-10, maxiter=500, side="right")
        res_l = sol_l(jnp.asarray(U0), jnp.asarray(U0))
        assert conv_d and bool(res_l.converged)
        assert iters_d == int(res_l.iters), (iters_d, int(res_l.iters))
        err = np.abs(x0[: D.shape[0]] - np.asarray(res_l.x)).max()
        scale = np.abs(np.asarray(res_l.x)).max()
        assert err < 1e-6 * scale, f"solution mismatch: {err} vs scale {scale}"
        print(f"OK process0 window halo={Ah.halo_units}u iters={iters_d} "
              f"err={err:.3e}", flush=True)
    _j.distributed.shutdown()


if __name__ == "__main__":
    main()
