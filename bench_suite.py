"""Full benchmark suite — the BASELINE.md north-star metrics.

Prints one JSON line per metric (bench.py remains the driver's single
flagship line):
  1. circulant_pc_applies_per_s_100cubed  — FFT direct solve, 100³
     (reference's largest registered case, tests/CMakeLists.txt:42)
  2. spmv_gnnz_per_s_kershaw              — wave BSR SpMV on a Kershaw-3
     sized mesh (32³ = 32,768 cells, meshes/README.md:37-40), ELL on device.
     (Host note: this box faults fresh mmap pages pathologically slowly —
     large-mesh preprocessing benefits from MALLOC_MMAP_MAX_=0
     MALLOC_TRIM_THRESHOLD_=-1; device timing is unaffected.)
  3. wave_implicit_step_ms_kershaw        — one implicit WaveSystem GMRES
     step (tol 1e-5, pbjacobi PC) on a Kershaw mesh, per-step wall time +
     iteration count (the reference prints but never records these,
     WaveSystem_..._impl_seq.cxx:138-148)

Baselines: SciPy pocketfft / scipy.sparse CSR on this host's CPU — the
single-node PETSc/FFTW stand-in (the reference publishes no numbers).

Timing: jitted lax.fori_loop chains ended by block_until_ready, differenced
between two chain lengths. Every record names the device it ran on.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np

import jax


def _dev_time(run, u0, K1=50, K2=250, reps=5):
    import jax  # noqa: F401

    def chain(K):
        t0 = time.perf_counter()
        np.asarray(run(u0, K))
        return time.perf_counter() - t0

    per = []
    for _ in range(reps):
        t1 = chain(K1)
        t2 = chain(K2)
        per.append((t2 - t1) / (K2 - K1))
    return max(statistics.median(per), 1e-7)


def bench_circulant():
    import jax
    import jax.numpy as jnp
    from scipy import fft as sfft

    from circulantpreconditioner_tpu.ops.circulant import (
        CirculantTransportOperator,
        np_eigenvalue_diagonal,
    )
    from circulantpreconditioner_tpu.ops.dft_matmul import MatmulCirculantSolver
    from circulantpreconditioner_tpu.ops.spectral_collapse import make_circulant_solver

    n = 100
    h = 1.0 / n
    dt = (1e3 / 3) * (h / 6)
    lambdas = (0.0, 0.0, 1.0 * dt / h)
    op = CirculantTransportOperator.create((n, n, n), lambdas, jnp.float32)
    u0 = jnp.asarray(np.random.default_rng(1).random((n, n, n)).astype(np.float32))

    def rate(solver, K1, K2):
        @jax.jit
        def run(u, K):
            return jax.lax.fori_loop(0, K, lambda i, v: solver.solve(v), u)

        jax.block_until_ready(run(u0, 4))
        np.asarray(run(u0, 4))
        return _dev_time(run, u0, K1=K1, K2=K2)

    # flagship: exact spectral collapse for the reference's a=(1,0,0) config
    flagship = make_circulant_solver((n, n, n), lambdas, jnp.float32, precision="highest")
    per = rate(flagship, K1=2000, K2=20000)
    staged = MatmulCirculantSolver.from_operator(op, precision="highest")
    per_staged = rate(staged, K1=500, K2=3000)

    lam = np_eigenvalue_diagonal((n, n, n), lambdas, rfft=True).astype(np.complex64)
    v = np.asarray(u0)
    sfft.irfftn(sfft.rfftn(v) / lam, s=v.shape)
    t0 = time.perf_counter()
    for _ in range(20):
        v = sfft.irfftn(sfft.rfftn(v) / lam, s=v.shape).astype(np.float32)
    base = (time.perf_counter() - t0) / 20
    return {"metric": "circulant_pc_applies_per_s_100cubed", "value": round(1 / per, 1),
            "unit": "solves/s", "vs_baseline": round(base / per, 1),
            "staged_full3d_solves_per_s": round(1 / per_staged, 1)}


def bench_spmv(n_side=32):
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.models import WaveSystem

    print(f"bench: building kershaw {n_side}^3 ...", file=sys.stderr, flush=True)
    mesh = kershaw_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
    A = model.divergence.to_csr(jnp.float32)
    nnz = A.nnz
    # field-major gather-free stencil — the explicit driver's production
    # path (the cell-major form pays (N,m)<->(m,N) relayouts per apply)
    D = model.divergence_op_fm()
    x_cm = np.random.default_rng(0).random(A.shape[0]).astype(np.float32)
    x0 = model.pack_fm(x_cm)

    @jax.jit
    def run(x, K):
        # dependent chain with renormalization to avoid overflow
        def body(i, v):
            y = D(v)
            return y / jnp.maximum(jnp.linalg.norm(y), 1e-30) * jnp.linalg.norm(v)
        return jax.lax.fori_loop(0, K, body, x)

    jax.block_until_ready(run(x0, 4))
    np.asarray(run(x0, 4))
    per = _dev_time(run, x0, K1=50, K2=250)

    As = A.to_scipy()
    xv = x_cm
    As @ xv
    t0 = time.perf_counter()
    for _ in range(20):
        yv = As @ xv
        xv = yv / max(np.linalg.norm(yv), 1e-30) * np.linalg.norm(xv)
    base = (time.perf_counter() - t0) / 20
    return {"metric": f"spmv_gnnz_per_s_kershaw{n_side}", "value": round(nnz / per / 1e9, 3),
            "unit": "Gnnz/s", "vs_baseline": round(base / per, 1)}


def bench_spmv_tet(n_side=16):
    """Tetrahedral supercell stencil SpMV (FVCA6 'gentle tetrahedra' analog)."""
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh.unstructured import tet_mesh
    from circulantpreconditioner_tpu.models import WaveSystem

    print(f"bench: building tet {n_side}^3 ...", file=sys.stderr, flush=True)
    mesh = tet_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
    A = model.divergence.to_csr(jnp.float32)
    nnz = A.nnz
    # field-major supercell stencil (6 tets/hex, 24x24 site blocks applied
    # as one grid-minor einsum)
    D = model.divergence_op_fm()
    x0 = model.pack_fm(np.random.default_rng(0).random(A.shape[0]).astype(np.float32))

    @jax.jit
    def run(x, K):
        def body(i, v):
            y = D(v)
            return y / jnp.maximum(jnp.linalg.norm(y), 1e-30) * jnp.linalg.norm(v)
        return jax.lax.fori_loop(0, K, body, x)

    jax.block_until_ready(run(x0, 4))
    np.asarray(run(x0, 4))
    per = _dev_time(run, x0, K1=50, K2=250)
    return {"metric": f"spmv_gnnz_per_s_tet{n_side}", "value": round(nnz / per / 1e9, 3),
            "unit": "Gnnz/s"}


def bench_pc_iterations(sides=(8, 16, 24)):
    """GMRES iteration counts on the Kershaw implicit wave step, by PC —
    the table the reference prints but never records
    (WaveSystem_..._impl_seq.cxx:138-148). cfl=1e3/3, tol 1e-5,
    right-preconditioned true-residual GMRES."""
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.models import WaveSystem
    from circulantpreconditioner_tpu.solvers import preconditioners as pcs
    from circulantpreconditioner_tpu.solvers.circulant_pc import (
        BlockCirculantProjectionPC,
        DCTBlockProjectionPC,
    )

    table = {}
    for n_side in sides:
        print(f"bench: pc iteration table, kershaw {n_side}^3 ...", file=sys.stderr,
              flush=True)
        mesh = kershaw_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
        model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
        coarse = BlockCirculantProjectionPC(mesh, model.dt, model.c0, dtype=jnp.float32)
        dct = DCTBlockProjectionPC(mesh, model.dt, model.c0, dtype=jnp.float32)
        pj = pcs.pbjacobi(model.divergence, shift=1.0)
        from circulantpreconditioner_tpu.solvers.aggregation_pc import (
            AggregationVCyclePC,
            GridVCyclePC,
        )

        gridmg = GridVCyclePC.from_grid_model(
            model.divergence, mesh.topology_shape, cells_per_site=1,
            A0_apply=model.implicit_matvec(), shift=1.0, dtype=jnp.float32)
        aggv = AggregationVCyclePC.from_bsr(
            model.divergence, A0_apply=model.implicit_matvec(), shift=1.0,
            factor=4, bottom_max=600, dtype=jnp.float32)
        pcs_by_name = {
            "none": None,
            "pbjacobi": pj,
            "circulant2l": pcs.additive(coarse.apply, pj),
            "dct2l": pcs.additive(dct.apply, pj),
            "dct2lm": pcs.multiplicative(model.implicit_matvec(), dct.apply, pj),
            "gridmg": gridmg.apply_partial(),
            "aggvcycle": aggv.apply_partial(),
        }
        row = {}
        for name, M in pcs_by_name.items():
            step = model.implicit_stepper(M=M, rtol=1e-5, atol=1e-5, maxiter=1000,
                                          side="right")
            out = jax.block_until_ready(step(model.initial_state()))
            row[name] = {"iters": int(np.asarray(out[2])),
                         "converged": bool(np.asarray(out[4]))}
        table[f"kershaw{n_side}"] = row
    return {"metric": "wave_implicit_gmres_iters_by_pc", "value": table,
            "unit": "iterations",
            "note": "gridmg/aggvcycle at kershaw8 (512 cells <= bottom_max) "
                    "degenerate to the exact dense inverse (hence 2 its); "
                    "aggvcycle is the UNSTRUCTURED-mesh tool - on these "
                    "recovered-grid meshes gridmg is the intended PC"}


def bench_wave_implicit(n_side=16, pc="gridmg"):
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.models import WaveSystem
    from circulantpreconditioner_tpu.solvers import preconditioners as pcs

    mesh = kershaw_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
    from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC
    from circulantpreconditioner_tpu.solvers.circulant_pc import (
        BlockCirculantProjectionPC,
        DCTBlockProjectionPC,
    )

    pj_fm = pcs.pbjacobi_fm(model.divergence, shift=1.0)
    if pc == "gridmg":
        # round-5 headline: geometric-Galerkin grid V-cycle, all-field-major
        # (kershaw 32³: 33 GMRES its vs dct2lm's 60, at lower apply cost)
        pc_obj = GridVCyclePC.from_grid_model(
            model.divergence, mesh.topology_shape, cells_per_site=1,
            A0_apply=model.implicit_matvec(),
            A0_apply_fm=model.implicit_matvec_fm(), shift=1.0,
            dtype=jnp.float32)
        M_cm, M_fm = None, pc_obj.apply_fm_partial()
    elif pc == "dct2lm":
        coarse = DCTBlockProjectionPC(mesh, model.dt, model.c0, dtype=jnp.float32)
        # field-major loop: fm matvec (no relayouts) + fm pbjacobi + the
        # coarse PC behind a single relayout-pair adapter
        M_cm, M_fm = None, pcs.multiplicative(
            model.implicit_matvec_fm(),
            pcs.cell_major_adapter(coarse.apply, model.nb), pj_fm)
    else:
        cls = (BlockCirculantProjectionPC if pc == "circulant2l"
               else DCTBlockProjectionPC)
        coarse = cls(mesh, model.dt, model.c0, dtype=jnp.float32)
        M_cm, M_fm = coarse.apply, pj_fm
    step = model.implicit_stepper_fm(
        M_cm=M_cm, M_fm=M_fm,
        rtol=1e-5, atol=1e-5, maxiter=1000, side="right")
    U = model.pack_fm(model.initial_state()).reshape(-1)
    out = jax.block_until_ready(step(U))
    np.asarray(out[0])
    iters = int(np.asarray(out[2]))
    converged = bool(np.asarray(out[4]))

    # differenced chain of t=0 solves (see bench_transport_implicit: the
    # physical loop decays toward 0-iteration solves)
    per_step = _t0_chain_time(step, U, K1=5, K2=20)
    rec = {"metric": f"wave_implicit_step_ms_kershaw{n_side}",
           "value": round(per_step * 1e3, 2), "unit": "ms/step", "pc": pc,
           "gmres_iters": iters, "converged": converged,
           "note": "t=0 solve (fixed iteration count) per step"}
    if pc == "gridmg":
        # BASELINE.md north star: implicit WaveSystem on the 3D Kershaw mesh
        # vs the single-node CPU stand-in (scipy GMRES + pbjacobi, same tol)
        print(f"bench: kershaw{n_side} scipy CPU baseline ...", file=sys.stderr,
              flush=True)
        per_base, base_iters = _scipy_implicit_baseline(
            model, np.asarray(model.initial_state()), reps=1)
        rec["vs_baseline"] = round(per_base / per_step, 1)
        rec["scipy_baseline_ms_per_step"] = round(per_base * 1e3, 1)
        rec["scipy_baseline_gmres_iters"] = base_iters
    return rec


def bench_wave_implicit_both(n_side=16):
    """Time the PC variants; headline (round 5) = the geometric-Galerkin
    grid V-cycle, the projection-PC family recorded alongside for
    traceability."""
    rec = bench_wave_implicit(n_side, pc="gridmg")
    for alt_pc in ("dct2lm", "dct2l", "circulant2l"):
        alt = bench_wave_implicit(n_side, pc=alt_pc)
        rec[f"{alt_pc}_ms_per_step"] = alt["value"]
        rec[f"{alt_pc}_gmres_iters"] = alt["gmres_iters"]
    return rec


def bench_wave_explicit(n_side=64):
    """Explicit wave stepping (the WaveSystem_..._expl_seq workload,
    U <- U - D U per step, :90-91) on Kershaw n³ — field-major state."""
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.models import WaveSystem

    print(f"bench: building kershaw {n_side}^3 (explicit) ...", file=sys.stderr,
          flush=True)
    mesh = kershaw_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model = WaveSystem(mesh, cfl=1.0 / 3, dtype=jnp.float32)  # expl default
    step = model.explicit_stepper_fm()
    G0 = model.pack_fm(model.initial_state())

    @jax.jit
    def run(g, K):
        return jax.lax.fori_loop(0, K, lambda i, v: step(v)[0], g)

    jax.block_until_ready(run(G0, 4))
    np.asarray(run(G0, 4))
    per = _dev_time(run, G0, K1=100, K2=500)
    return {"metric": f"wave_explicit_step_us_kershaw{n_side}",
            "value": round(per * 1e6, 1), "unit": "us/step",
            "unknowns": int(model.divergence.shape[0]),
            "operator": "normal-form stencil, field-major"}


def bench_wave_dct_direct(n_side=64):
    """DIRECT wall-BC implicit wave solve via the exact DCT/DST block
    diagonalization — no GMRES at all on the reference's default cartesian
    wall meshes (its impl_seq runs GMRES+ILU on this exact operator)."""
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh import cartesian_mesh
    from circulantpreconditioner_tpu.models import WaveSystem

    mesh = cartesian_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
    # field-major loop: the cell-major stepper pays (…,nb)↔(nb,…) relayouts
    # worth ~6x the whole solve pipeline per step (ops/dct_wave.solve_fm)
    step = model.dct_fft_stepper_fm()
    U0 = model.pack_fm(model.initial_state())

    @jax.jit
    def run(u, K):
        return jax.lax.fori_loop(0, K, lambda i, v: step(v)[0], u)

    jax.block_until_ready(run(U0, 2))
    np.asarray(run(U0, 2))
    per = _dev_time(run, U0, K1=50, K2=250)
    return {"metric": f"wave_dct_direct_us_per_step_{n_side}cubed",
            "value": round(per * 1e6, 1), "unit": "us/step",
            "unknowns": int(model.divergence.shape[0]),
            "note": "exact wall-BC direct solve (field-major loop), "
                    "replaces GMRES+ILU"}


def bench_wave_ilu(n_side=32):
    """GMRES + ILU(0) on the cartesian wall-BC implicit wave system — the
    reference's DEFAULT sequential solver config
    (WaveSystem_SphericalExplosion_impl_seq.cxx:31-33), whose apply cost
    was never recorded. Records the ILU apply time
    (level-scheduled triangular sweeps), the GMRES+ILU t=0 step, and the
    iteration count; the exact DCT/DST direct solve on the same operator
    (wave_dct_direct) is the number to compare against. At the reference's
    own cfl=1e3/dim ILU-preconditioned GMRES STALLS in both this framework
    and SciPy (tests/test_krylov.py nonconvergence parity), so the solver
    here runs at the largest cfl where it converges-ish and the record
    carries the honest converged flag."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from circulantpreconditioner_tpu.mesh import cartesian_mesh
    from circulantpreconditioner_tpu.models import WaveSystem
    from circulantpreconditioner_tpu.ops.csr import CSRMatrix
    from circulantpreconditioner_tpu.solvers import make_gmres, preconditioners as pcs

    mesh = cartesian_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
    print(f"bench: ILU(0) factor at {n_side}^3 ...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    A_I = CSRMatrix.from_scipy(
        (sp.eye(model.divergence.shape[0])
         + model.divergence.to_csr(jnp.float32).to_scipy()).tocsr(),
        dtype=jnp.float32)
    ilu = pcs.ilu0(A_I)
    t_factor = time.perf_counter() - t0
    M = ilu.apply_partial() if hasattr(ilu, "apply_partial") else ilu.apply

    U0 = model.initial_state()

    # ILU apply alone
    @jax.jit
    def run_apply(M_, u, K):
        def body(i, v):
            y = M_(v)
            return y / jnp.maximum(jnp.linalg.norm(y), 1e-30) * jnp.linalg.norm(v)
        return jax.lax.fori_loop(0, K, body, u)

    jax.block_until_ready(run_apply(M, U0, 2))
    np.asarray(run_apply(M, U0, 2))
    per_apply = _dev_time(lambda u, K: run_apply(M, u, K), U0, K1=3, K2=9)

    A_op = model.implicit_matvec()
    solver = make_gmres(A_op, M, rtol=1e-5, atol=1e-5, maxiter=100,
                        side="left")
    out = jax.block_until_ready(solver(U0, U0))
    iters = int(np.asarray(out.iters))
    conv = bool(np.asarray(out.converged))

    # the apply is scan-latency-bound (one lax.scan step per triangular
    # level), so per-step = iters × (apply + matvec) to within measurement
    # noise; chain two single solves instead of long chains
    @jax.jit
    def run_imp(A_, M_, u, K):
        sol = make_gmres(A_, M_, rtol=1e-5, atol=1e-5, maxiter=100,
                         side="left")

        def body(i, v):
            u_in = U0 + (1e-30 * jnp.linalg.norm(v)) * v
            return sol(u_in, u_in).x
        return jax.lax.fori_loop(0, K, body, u)

    jax.block_until_ready(run_imp(A_op, M, U0, 1))
    np.asarray(run_imp(A_op, M, U0, 1))
    per_step = _dev_time(lambda u, K: run_imp(A_op, M, u, K), U0, K1=1, K2=2,
                         reps=2)

    return {"metric": f"wave_ilu0_step_ms_{n_side}cubed",
            "value": round(per_step * 1e3, 1), "unit": "ms/step",
            "unknowns": int(A_I.shape[0]),
            "pc": "ilu0 (scan-scheduled level sweeps)",
            "gmres_iters": iters, "converged": conv,
            "ilu_apply_ms": round(per_apply * 1e3, 2),
            "setup_s": round(t_factor, 1),
            "note": "reference impl_seq default PC; compare "
                    "wave_dct_direct_us_per_step (exact direct solve, no "
                    "Krylov) on the same operator. setup_s is one-time"}


def bench_diffusion_implicit(n_side=64):
    """Implicit diffusion (the reference roadmap's named next capability,
    ToDo.md:5-6): CG step time + iterations, and the FFT direct solve on
    the periodic grid, at n³."""
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh import cartesian_mesh
    from circulantpreconditioner_tpu.models import DiffusionEquation

    mesh = cartesian_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model = DiffusionEquation(mesh, cfl=10.0, dtype=jnp.float32)
    u0 = model.initial_state()
    step = model.implicit_stepper(rtol=1e-5, atol=1e-5, maxiter=1000)
    out = jax.block_until_ready(step(u0))
    iters = int(np.asarray(out[2]))
    conv = bool(np.asarray(out[4]))

    @jax.jit
    def run(u, K):
        return jax.lax.fori_loop(0, K, lambda i, v: step(v)[0], u)

    jax.block_until_ready(run(u0, 2))
    np.asarray(run(u0, 2))
    totals = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(run(u0, 20))
        totals.append(time.perf_counter() - t0)
    per = min(totals) / 20

    meshp = cartesian_mesh(((0.0, 1.0),) * 3, (n_side,) * 3, periodic=True)
    modelp = DiffusionEquation(meshp, cfl=10.0, dtype=jnp.float32)
    fft_step = modelp.fft_stepper()
    up = modelp.initial_state()

    @jax.jit
    def runf(u, K):
        return jax.lax.fori_loop(0, K, lambda i, v: fft_step(v)[0], u)

    jax.block_until_ready(runf(up, 4))
    np.asarray(runf(up, 4))
    perf_ = _dev_time(runf, up, K1=100, K2=500)
    return {"metric": f"diffusion_implicit_step_ms_{n_side}cubed",
            "value": round(per * 1e3, 2), "unit": "ms/step",
            "cg_iters": iters, "converged": conv,
            "fft_direct_us_per_step_periodic": round(perf_ * 1e6, 1)}


def bench_transport_implicit(n_side=100):
    """The reference's flagship Krylov case: implicit transport GMRES on the
    100³ cube, a=(1,0,0), cfl=1e3/3, tol 1e-5
    (TransportEquation_SphericalExplosion_impl_mpi.cxx:233-236,258-259 —
    GMRES+PCNONE, per-solve wall time printed :131-137). Headline = the
    circulant-PC run: the acceleration the reference project was built to
    demonstrate and never wired (ToDo.md:1). The wall/Neumann operator
    differs from the periodic circulant only on the boundary layer, so the
    FFT solve preconditions it to ~2 iterations at any size."""
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh import cartesian_mesh
    from circulantpreconditioner_tpu.models import TransportEquation

    mesh = cartesian_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model = TransportEquation(mesh, velocity=[1.0, 0.0, 0.0], cfl=1e3 / 3,
                              dtype=jnp.float32)
    u0 = model.initial_state()

    def run_case(M, side, K1, K2, restart=30):
        """Differenced-chain timing (bench.py methodology) of the t=0 solve.

        Chaining the physical time loop lets the explosion smear to stationarity, after which solves
        exit at 0 iterations — the chain must re-solve the REFERENCE's
        hardest step (t=0, fixed iteration count) every link, so each link
        feeds u0 plus a vanishing data dependence on the previous solve."""
        step = model.implicit_stepper(M=M, rtol=1e-5, atol=1e-5, maxiter=1000,
                                      side=side, restart=restart)
        out = jax.block_until_ready(step(u0))
        iters = int(np.asarray(out[2]))
        conv = bool(np.asarray(out[4]))

        @jax.jit
        def run(u, K):
            def body(i, v):
                u_in = u0 + (1e-30 * jnp.linalg.norm(v)) * v
                return step(u_in)[0]
            return jax.lax.fori_loop(0, K, body, u)

        jax.block_until_ready(run(u0, 2))
        np.asarray(run(u0, 2))
        per = _dev_time(run, u0, K1=K1, K2=K2, reps=3)
        # the decayed late-time count, for the record (the time loop's cost
        # per step falls toward one matvec as the state goes stationary)
        @jax.jit
        def loop(u, K):
            return jax.lax.fori_loop(0, K, lambda i, v: step(v)[0], u)
        it_steady = int(np.asarray(step(loop(u0, 50))[2]))
        return per, iters, conv, it_steady

    print("bench: transport 100^3 GMRES + circulant PC ...", file=sys.stderr,
          flush=True)
    from circulantpreconditioner_tpu.ops.spectral_collapse import (
        make_circulant_solver,
    )

    op = model.fft_operator
    M_pc = make_circulant_solver(op.shape_zyx, op.lambdas_zyx,
                                 dtype=jnp.float32,
                                 precision="highest").as_preconditioner()
    # small restart: the PC converges in ~3 iterations, so a 31-row Krylov
    # basis would make the CGS2 projections (full-matrix (m+1,N) matvecs)
    # the dominant cost at N=1e6
    per_pc, it_pc, conv_pc, it_pc_ss = run_case(M_pc, "right", K1=20, K2=120,
                                                restart=8)
    print("bench: transport 100^3 GMRES + PCNONE (reference config) ...",
          file=sys.stderr, flush=True)
    per_no, it_no, conv_no, it_no_ss = run_case(None, "left", K1=2, K2=6)
    return {"metric": f"transport_implicit_step_ms_{n_side}cubed",
            "value": round(per_pc * 1e3, 3), "unit": "ms/step",
            "pc": "circulant (periodic FFT solve, right-PC true residual)",
            "note": "t=0 solve (fixed iteration count) per step; late-time "
                    "steps decay to the *_steady counts",
            "gmres_iters_first_step": it_pc, "gmres_iters_steady": it_pc_ss,
            "converged": conv_pc,
            "pcnone_ms_per_step": round(per_no * 1e3, 2),
            "pcnone_gmres_iters_first_step": it_no,
            "pcnone_gmres_iters_steady": it_no_ss,
            "pcnone_converged": conv_no}


def _t0_chain_time(step, u0, K1, K2):
    """Differenced chain of t=0 solves (see bench_transport_implicit):
    each link re-solves from the initial state plus a vanishing data
    dependence on the previous link, so per-link work never decays."""
    import jax
    import jax.numpy as jnp


    @jax.jit
    def run(u, K):
        def body(i, v):
            u_in = u0 + (1e-30 * jnp.linalg.norm(v)) * v
            return step(u_in)[0]
        return jax.lax.fori_loop(0, K, body, u)

    jax.block_until_ready(run(u0, 2))
    np.asarray(run(u0, 2))
    return _dev_time(run, u0, K1=K1, K2=K2, reps=3)


def bench_fixture_ladder(rel="3DTetrahedra_Kershaw/3DKershawTetra2.med",
                         label="ktetra2", K1=3, K2=9):
    """The reference's own fixture files, near the top of its mesh ladder
    (meshes/README.md:22-40), on the real chip. 3DKershawTetra2.med is the
    largest fixture present in the snapshot (93,440 tets / 373,760 wave
    unknowns; Tetra3 at 766,976 and Kershaw3/4 are absent large blobs —
    /root/reference/.MISSING_LARGE_BLOBS). Loaded through the full pipeline:
    node weld → non-conforming sub-face matching → grid-topology recovery or
    RCM bandwidth ordering → windowed/varying SpMV. Records SpMV Gnnz/s
    (true nnz), explicit step, and the implicit GMRES+dct2lm step (t=0
    solve) with iteration count."""
    import os

    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh import read_mesh
    from circulantpreconditioner_tpu.models import WaveSystem
    from circulantpreconditioner_tpu.solvers import preconditioners as pcs

    path = os.path.join("/root/reference/meshes", rel)
    print(f"bench: loading fixture {rel} ...", file=sys.stderr, flush=True)
    mesh = read_mesh(path)
    model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
    A = model.divergence
    nnz = int(np.count_nonzero(np.asarray(A.blocks)))
    route = ("varying-stencil" if getattr(mesh, "topology_shape", None)
             else "clustered-window")
    D = model.divergence_op()
    x0 = jnp.asarray(
        np.random.default_rng(0).random(A.shape[0]).astype(np.float32))

    # D enters as an ARGUMENT: the windowed operator carries a few hundred
    # MB of window matrices, which as a closure constant would be inlined
    # into the HLO
    @jax.jit
    def run_spmv(D_, x, K):
        def body(i, v):
            y = D_(v)
            return y / jnp.maximum(jnp.linalg.norm(y), 1e-30) * jnp.linalg.norm(v)
        return jax.lax.fori_loop(0, K, body, x)

    jax.block_until_ready(run_spmv(D, x0, 2))
    np.asarray(run_spmv(D, x0, 2))
    per_spmv = _dev_time(lambda x, K: run_spmv(D, x, K), x0, K1=20, K2=100)

    # explicit stepping (expl_seq analog; cfl=1/dim); D again an argument
    model_e = WaveSystem(mesh, cfl=1.0 / 3, dtype=jnp.float32)
    fm_De = model_e.divergence_op_fm()
    if fm_De is not None:
        D_e = fm_De
        u_e = model_e.pack_fm(model_e.initial_state())
    else:
        D_e = model_e.divergence_op()
        u_e = model_e.initial_state()

    @jax.jit
    def run_exp(D_, u, K):
        return jax.lax.fori_loop(0, K, lambda i, v: v - D_(v), u)

    jax.block_until_ready(run_exp(D_e, u_e, 2))
    np.asarray(run_exp(D_e, u_e, 2))
    per_exp = _dev_time(lambda u, K: run_exp(D_e, u, K), u_e, K1=20, K2=100)

    # implicit GMRES. Headline PC (round 5): the aggregation multilevel
    # V-cycle (solvers/aggregation_pc.py) — the adaptive coarse space that
    # converges on the strongly-warped FVCA6 fixtures where every cartesian
    # projection variant measured neutral-to-divergent (round-4 negative
    # result; the reference's own default ILU(0) is exactly singular on the
    # KTetra operator). pbjacobi — round 4's honest fallback — is recorded
    # alongside for traceability.
    from circulantpreconditioner_tpu.solvers import make_gmres
    from circulantpreconditioner_tpu.solvers.aggregation_pc import (
        AggregationVCyclePC,
    )

    A_op = model.implicit_matvec()
    U0 = model.initial_state()

    # chain runner takes the operator/PC pytrees as jit ARGUMENTS (the
    # windowed A would otherwise be a >300 MB HLO constant -> HTTP 413)
    @jax.jit
    def run_imp(A_, M_, u, K):
        sol = make_gmres(A_, M_, rtol=1e-5, atol=1e-5, maxiter=1000,
                         side="right")

        def body(i, v):
            u_in = U0 + (1e-30 * jnp.linalg.norm(v)) * v
            return sol(u_in, u_in).x
        return jax.lax.fori_loop(0, K, body, u)

    results = {}
    if getattr(mesh, "topology_shape", None) is not None:
        # recovered-grid fixture (Kershaw hex family): the geometric-Galerkin
        # grid V-cycle with gather-free levels, field-major end to end
        from circulantpreconditioner_tpu.solvers.aggregation_pc import (
            GridVCyclePC,
        )

        cps = int(getattr(mesh, "cells_per_site", 1) or 1)
        head_name = "gridmg"
        head_pc = GridVCyclePC.from_grid_model(
            model.divergence, mesh.topology_shape, cells_per_site=cps,
            A0_apply=A_op, A0_apply_fm=model.implicit_matvec_fm(),
            shift=1.0, dtype=jnp.float32)
    else:
        head_name = "aggvcycle"
        head_pc = AggregationVCyclePC.from_bsr(
            model.divergence, A0_apply=A_op, shift=1.0, factor=4,
            bottom_max=1200, dtype=jnp.float32)
    pc_by_name = {head_name: head_pc.apply_partial(),
                  "pbjacobi": pcs.pbjacobi(model.divergence, shift=1.0)}
    for pc_name, M in pc_by_name.items():
        print(f"bench: {label} implicit ({pc_name}) ...", file=sys.stderr,
              flush=True)
        if (pc_name == "gridmg"
                and model.implicit_matvec_fm() is not None):
            step = model.implicit_stepper_fm(
                M_fm=head_pc.apply_fm_partial(), rtol=1e-5, atol=1e-5,
                maxiter=1000, side="right")
            Ufm = model.pack_fm(np.asarray(U0)).reshape(-1)
            out = jax.block_until_ready(step(Ufm))
            iters = int(np.asarray(out[2]))
            conv = bool(np.asarray(out[4]))
            per = _t0_chain_time(step, Ufm, K1=K1, K2=K2)
        else:
            solver = make_gmres(A_op, M, rtol=1e-5, atol=1e-5, maxiter=1000,
                                side="right")
            out = jax.block_until_ready(solver(U0, U0))
            iters = int(np.asarray(out.iters))
            conv = bool(np.asarray(out.converged))
            jax.block_until_ready(run_imp(A_op, M, U0, 2))
            np.asarray(run_imp(A_op, M, U0, 2))
            per = _dev_time(lambda u, K: run_imp(A_op, M, u, K), U0, K1=K1,
                            K2=K2)
        results[pc_name] = (per, iters, conv)

    # CPU baseline: scipy.sparse GMRES + pbjacobi at the same tolerances —
    # the single-node PETSc stand-in for BASELINE.md's ">=7x per-chip on the
    # 3D Kershaw meshes" north star (previously asserted, not evidenced)
    print(f"bench: {label} scipy CPU baseline ...", file=sys.stderr, flush=True)
    per_base, base_iters = _scipy_implicit_baseline(model, np.asarray(U0))

    per_imp, iters, conv = results[head_name]
    per_pj, it_pj, conv_pj = results["pbjacobi"]
    return {"metric": f"wave_implicit_step_ms_{label}",
            "value": round(per_imp * 1e3, 2), "unit": "ms/step",
            "cells": int(mesh.n_cells), "unknowns": int(A.shape[0]),
            "pc": head_name, "gmres_iters": iters, "converged": conv,
            "pbjacobi_ms_per_step": round(per_pj * 1e3, 2),
            "pbjacobi_gmres_iters": it_pj, "pbjacobi_converged": conv_pj,
            "vs_baseline": round(per_base / per_imp, 1),
            "scipy_baseline_ms_per_step": round(per_base * 1e3, 1),
            "scipy_baseline_gmres_iters": base_iters,
            "spmv_route": route,
            "spmv_gnnz_per_s": round(nnz / per_spmv / 1e9, 3),
            "explicit_us_per_step": round(per_exp * 1e6, 1),
            "note": "t=0 solve per step (see transport_implicit note)"}


def _scipy_implicit_baseline(model, U0, reps=2):
    """One t=0 implicit solve with scipy.sparse GMRES + point-block-Jacobi
    (same tol/restart as the device runs). Returns (seconds, iterations)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    D = model.divergence
    b = D.block_size
    A = (sp.identity(D.shape[0], format="csr")
         + D.to_csr().to_scipy().astype(np.float64)).tocsr()
    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()).astype(np.float64)
                         + np.eye(b)[None, :, :])

    def pb(r):
        return np.einsum("nij,nj->ni", Dinv, r.reshape(-1, b)).reshape(-1)

    rhs = np.asarray(U0, dtype=np.float64)
    it = [0]

    def cb(_):
        it[0] += 1

    best = None
    for _ in range(reps):
        it[0] = 0
        t0 = time.perf_counter()
        x, info = spla.gmres(A, rhs, rtol=1e-5, atol=1e-5 * np.linalg.norm(rhs),
                             restart=30, maxiter=34,
                             M=spla.LinearOperator(A.shape, pb), callback=cb,
                             callback_type="pr_norm")
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, it[0]


def bench_ladder_top(n_side=50):
    """The TOP rung of the reference's mesh ladder, generated: KershawTetra3
    (766,976 tets) is an absent large blob in the snapshot
    (/root/reference/.MISSING_LARGE_BLOBS), so this benches the generated
    analog — Kershaw-warped hexes split 6-ways, 6·50³ = 750,000 tets ≈ 3.0M
    wave unknowns (mesh/unstructured.kershaw_tet_mesh). Records the
    block-sparse supercell SpMV, explicit stepping, and the implicit GMRES
    step with the geometric-Galerkin grid V-cycle PC (the cartesian
    projection PC measurably diverges on warped tet meshes — round 5), plus
    device-resident operator/PC footprints and a scipy CPU baseline."""
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh import kershaw_tet_mesh
    from circulantpreconditioner_tpu.models import WaveSystem
    from circulantpreconditioner_tpu.models.wave import _identity_plus
    from circulantpreconditioner_tpu.solvers import make_gmres, preconditioners as pcs
    from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC

    def dev_bytes(t):
        return int(sum(l.size * l.dtype.itemsize
                       for l in jax.tree_util.tree_leaves(t)
                       if hasattr(l, "dtype")))

    print(f"bench: generating kershaw-tet {n_side}^3 (6x{n_side**3} tets) ...",
          file=sys.stderr, flush=True)
    mesh = kershaw_tet_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model_e = WaveSystem(mesh, cfl=1.0 / 3, dtype=jnp.float32)
    nnz = int(np.count_nonzero(np.asarray(model_e.divergence.blocks)))
    D_fm = model_e.divergence_op_fm(flat=True)
    G0 = model_e.pack_fm(model_e.initial_state()).reshape(-1)

    @jax.jit
    def run_spmv(D_, x, K):
        def body(i, v):
            y = D_(v)
            return y / jnp.maximum(jnp.linalg.norm(y), 1e-30) * jnp.linalg.norm(v)
        return jax.lax.fori_loop(0, K, body, x)

    jax.block_until_ready(run_spmv(D_fm, G0, 2))
    np.asarray(run_spmv(D_fm, G0, 2))
    per_spmv = _dev_time(lambda x, K: run_spmv(D_fm, x, K), G0, K1=20, K2=100)

    @jax.jit
    def run_exp(D_, u, K):
        return jax.lax.fori_loop(0, K, lambda i, v: v - D_(v), u)

    jax.block_until_ready(run_exp(D_fm, G0, 2))
    np.asarray(run_exp(D_fm, G0, 2))
    per_exp = _dev_time(lambda u, K: run_exp(D_fm, u, K), G0, K1=20, K2=100)

    # implicit: FIELD-MAJOR GMRES (the cell-major supercell operator is the
    # dense (24×24)-block form — 2.0 GB at this size vs 240 MB block-sparse)
    print("bench: ladder-top implicit (grid V-cycle PC) ...", file=sys.stderr,
          flush=True)
    model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
    A_fm = jax.tree_util.Partial(_identity_plus,
                                 model.divergence_op_fm(flat=True))
    # the fine level MUST reuse the block-sparse supercell operator: letting
    # from_grid_model build its own VaryingStencilOperator stores the dense
    # (24x24)-block form - 2.0 GB at this size, and the V-cycle then streams
    # it twice per iteration (measured 1129 ms/step vs ~8x less traffic here)
    pc = GridVCyclePC.from_grid_model(
        model.divergence, mesh.topology_shape, cells_per_site=6,
        A0_apply=A_fm, A0_apply_fm=A_fm, shift=1.0, dtype=jnp.float32)
    # the GMRES loop is field-major; apply the cycle field-major too
    # (the cell-major cycle would route the fm fine operator wrong)
    M = pc.apply_fm_partial()
    U0 = model.pack_fm(model.initial_state()).reshape(-1)

    sol = make_gmres(A_fm, M, rtol=1e-5, atol=1e-5, maxiter=1000,
                     side="right")
    out = jax.block_until_ready(sol(U0, U0))
    iters = int(np.asarray(out.iters))
    conv = bool(np.asarray(out.converged))

    @jax.jit
    def run_imp(A_, M_, u, K):
        s = make_gmres(A_, M_, rtol=1e-5, atol=1e-5, maxiter=1000,
                       side="right")

        def body(i, v):
            u_in = U0 + (1e-30 * jnp.linalg.norm(v)) * v
            return s(u_in, u_in).x
        return jax.lax.fori_loop(0, K, body, u)

    jax.block_until_ready(run_imp(A_fm, M, U0, 1))
    np.asarray(run_imp(A_fm, M, U0, 1))
    per_imp = _dev_time(lambda u, K: run_imp(A_fm, M, u, K), U0, K1=1, K2=3,
                        reps=2)

    print("bench: ladder-top scipy CPU baseline ...", file=sys.stderr, flush=True)
    per_base, base_iters = _scipy_implicit_baseline(
        model, np.asarray(model.initial_state()), reps=1)

    return {"metric": "wave_implicit_step_ms_kershawtet50",
            "value": round(per_imp * 1e3, 1), "unit": "ms/step",
            "cells": int(mesh.n_cells), "unknowns": int(model.divergence.shape[0]),
            "pc": f"grid-vcycle ({pc.n_levels} levels)",
            "gmres_iters": iters, "converged": conv,
            "vs_baseline": round(per_base / per_imp, 1),
            "scipy_baseline_ms_per_step": round(per_base * 1e3, 1),
            "scipy_baseline_gmres_iters": base_iters,
            "spmv_route": "block-sparse supercell stencil (field-major)",
            "spmv_gnnz_per_s": round(nnz / per_spmv / 1e9, 3),
            "explicit_us_per_step": round(per_exp * 1e6, 1),
            "operator_dev_mb": round(dev_bytes(D_fm) / 1e6, 1),
            "pc_dev_mb": round(dev_bytes(pc.apply_fm_partial()) / 1e6, 1),
            "note": "generated KershawTetra3-rung analog (fixture blob absent); "
                    "t=0 solve per step (see transport_implicit note)"}


def bench_transport_fixture(rel="3DKershaw/Kershaw2.med", label="kershaw2med",
                            K1=5, K2=20):
    """Implicit transport GMRES on a LOADED reference fixture — the
    reference PCSHELL's target configuration
    (/root/reference/src/PCSHELLFft_3D.cxx:10-24 builds its FFT context from
    an unstructured transport mesh). Headline PC = the aggregation V-cycle;
    PCNONE recorded for the speedup. MEASURED NEGATIVE RESULT (round 5): the
    cartesian projection PC (CirculantProjectionPC) DIVERGES on the loaded
    fixtures (mesh_tetra_0/2, Kershaw2.med: 1000 its unconverged vs
    48-177 for PCNONE) — same failure mode as the wave-system fixtures
    (round 4), so the adaptive algebraic coarse space is the production
    answer there too."""
    import os

    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh import read_mesh
    from circulantpreconditioner_tpu.models import TransportEquation
    from circulantpreconditioner_tpu.ops.csr import BSRMatrix
    from circulantpreconditioner_tpu.solvers import make_gmres
    from circulantpreconditioner_tpu.solvers.aggregation_pc import (
        AggregationVCyclePC,
    )

    path = os.path.join("/root/reference/meshes", rel)
    print(f"bench: transport fixture {rel} ...", file=sys.stderr, flush=True)
    mesh = read_mesh(path)
    model = TransportEquation(mesh, velocity=[1.0, 0.0, 0.0], cfl=1e3 / 3,
                              dtype=jnp.float32)
    A_op = model.implicit_matvec()
    u0 = model.initial_state()
    D = model.divergence  # scalar CSR
    sp_ = D.to_scipy().tocoo()
    Db = BSRMatrix.from_block_coo(D.shape[0], D.shape[1], sp_.row, sp_.col,
                                  sp_.data.reshape(-1, 1, 1), dtype=jnp.float32)
    if getattr(mesh, "topology_shape", None) is not None:
        from circulantpreconditioner_tpu.solvers.aggregation_pc import (
            GridVCyclePC,
        )

        pc = GridVCyclePC.from_grid_model(
            Db, mesh.topology_shape,
            cells_per_site=int(getattr(mesh, "cells_per_site", 1) or 1),
            A0_apply=A_op, shift=1.0, dtype=jnp.float32)
        pc_label = "gridmg"
    else:
        pc = AggregationVCyclePC.from_bsr(Db, A0_apply=A_op, shift=1.0,
                                          factor=4, bottom_max=1200,
                                          dtype=jnp.float32)
        pc_label = "aggvcycle"

    @jax.jit
    def run_imp(A_, M_, u, K):
        sol = make_gmres(A_, M_, rtol=1e-5, atol=1e-5, maxiter=1000,
                         side="right")

        def body(i, v):
            u_in = u0 + (1e-30 * jnp.linalg.norm(v)) * v
            return sol(u_in, u_in).x
        return jax.lax.fori_loop(0, K, body, u)

    rec = {}
    for name, M, side in ((pc_label, pc.apply_partial(), "right"),
                          ("pcnone", None, "left")):
        sol = make_gmres(A_op, M, rtol=1e-5, atol=1e-5, maxiter=1000,
                         side=side)
        out = jax.block_until_ready(sol(u0, u0))
        if name == "pcnone":
            # PCNONE left == right; reuse the right-PC chain runner shape
            M = jax.tree_util.Partial(lambda r: r)
        jax.block_until_ready(run_imp(A_op, M, u0, 2))
        np.asarray(run_imp(A_op, M, u0, 2))
        per = _dev_time(lambda u, K: run_imp(A_op, M, u, K), u0, K1=K1, K2=K2)
        rec[name] = (per, int(np.asarray(out.iters)),
                     bool(np.asarray(out.converged)))

    per, iters, conv = rec[pc_label]
    per_no, it_no, conv_no = rec["pcnone"]
    return {"metric": f"transport_implicit_step_ms_{label}",
            "value": round(per * 1e3, 2), "unit": "ms/step",
            "cells": int(mesh.n_cells), "pc": pc_label,
            "gmres_iters": iters, "converged": conv,
            "pcnone_ms_per_step": round(per_no * 1e3, 2),
            "pcnone_gmres_iters": it_no, "pcnone_converged": conv_no,
            "note": "t=0 solve per step; cartesian projection PC diverges on "
                    "loaded fixtures (measured negative result, round 5)"}


def bench_scale_distributed(n_side=32, devices=8):
    """Scale experiment on the reference's mesh ladder (meshes/README.md:30-40):
    Kershaw n³ implicit wave, row-sharded GMRES over `devices` virtual CPU
    devices with the distributed two-level circulant PC (halo all_to_all
    apply). Runs in a CPU subprocess; records GMRES iterations, per-step
    time, and the PC halo widths."""
    import os
    import subprocess

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--scale-worker",
         str(n_side), str(devices)],
        env=env, capture_output=True, text=True, timeout=3000, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _scale_worker(n_side: int, devices: int):
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.mesh.unstructured import kershaw_mesh
    from circulantpreconditioner_tpu.models import WaveSystem
    from circulantpreconditioner_tpu.parallel import HaloELLMatrix, device_mesh
    from circulantpreconditioner_tpu.parallel.pc_dist import (
        DistributedBlockCirculantPC,
        sharded_pbjacobi,
    )
    from circulantpreconditioner_tpu.solvers import make_gmres, preconditioners as pcs

    print(f"scale: building kershaw {n_side}^3 ...", file=sys.stderr, flush=True)
    mesh = kershaw_mesh(((0.0, 1.0),) * 3, (n_side,) * 3)
    model = WaveSystem(mesh, cfl=1e3 / 3, dtype=jnp.float32)
    dm = device_mesh(devices)
    D = model.divergence
    b = D.block_size
    A = D.to_csr(jnp.float32)
    Ah = HaloELLMatrix(A, dm, row_multiple=b)
    print(f"scale: n={Ah.n} padded={Ah.n_padded} spmv_halo={Ah.halo}",
          file=sys.stderr, flush=True)
    coarse = DistributedBlockCirculantPC(mesh, model.dt, model.c0, dm,
                                         Ah.n_padded, dtype=jnp.float32)
    Dinv = np.linalg.inv(np.asarray(D.block_diagonal()) + np.eye(b)[None, :, :])
    M = pcs.additive(coarse.apply,
                     sharded_pbjacobi(Dinv, Ah.n_padded, dm, dtype=jnp.float32))
    Aop = jax.tree_util.Partial(
        lambda spmv, x: x + spmv(x), Ah.matvec_partial())
    solver = make_gmres(Aop, M, rtol=1e-5, atol=1e-5, maxiter=1000, side="right")
    U0 = Ah.shard_vector(np.asarray(model.initial_state()))

    res = solver(U0, U0)
    iters = int(np.asarray(res.iters))
    converged = bool(np.asarray(res.converged))
    print(f"scale: step-1 GMRES iters={iters} converged={converged}",
          file=sys.stderr, flush=True)

    # round-5 comparison: the geometric-Galerkin grid V-cycle under plain
    # GSPMD sharding (reshape transfers + varying-stencil levels lower to
    # collectives automatically; iteration parity with single-device is
    # asserted in __graft_entry__.dryrun_multichip stage (e))
    from jax.sharding import NamedSharding, PartitionSpec as PSpec

    from circulantpreconditioner_tpu.solvers.aggregation_pc import GridVCyclePC

    gpc = GridVCyclePC.from_grid_model(
        D, mesh.topology_shape, cells_per_site=1,
        A0_apply=model.implicit_matvec(), shift=1.0, dtype=jnp.float32)
    solver_g = make_gmres(model.implicit_matvec(), gpc.apply_partial(),
                          rtol=1e-5, atol=1e-5, maxiter=1000, side="right")
    Ug = jax.device_put(np.asarray(model.initial_state()),
                        NamedSharding(dm, PSpec("shard")))
    res_g = solver_g(Ug, Ug)
    g_iters = int(np.asarray(res_g.iters))
    g_conv = bool(np.asarray(res_g.converged))
    print(f"scale: gridmg GSPMD iters={g_iters} converged={g_conv}",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter(); jax.block_until_ready(solver_g(Ug, Ug).x)
    t1 = time.perf_counter(); jax.block_until_ready(
        jax.jit(lambda u: solver_g(u, u).x)(Ug))
    g_ms = (t1 - t0) * 1e3

    @jax.jit
    def run(u, K):
        return jax.lax.fori_loop(0, K, lambda i, v: solver(v, v).x, u)

    np.asarray(jax.device_get(run(U0, 1)))  # compile + warm
    import statistics as st
    per = []
    for K1, K2 in ((1, 3), (1, 3), (1, 3)):
        t0 = time.perf_counter(); jax.block_until_ready(run(U0, K1)); t1 = time.perf_counter()
        jax.block_until_ready(run(U0, K2)); t2 = time.perf_counter()
        per.append(((t2 - t1) - (t1 - t0)) / (K2 - K1))
    per_step = st.median(per)
    print(json.dumps({
        "metric": f"wave_implicit_dist_kershaw{n_side}_{devices}dev",
        "value": round(per_step * 1e3, 1), "unit": "ms/step",
        "gmres_iters": iters, "converged": converged,
        "unknowns": int(A.shape[0]), "pc": "circulant2l (halo all_to_all)",
        "pc_halo_fwd": int(coarse.halo_fwd), "pc_halo_bak": int(coarse.halo_bak),
        "spmv_halo": int(Ah.halo), "device": f"cpu x{devices} (virtual)",
        "gridmg_gspmd_iters": g_iters, "gridmg_gspmd_converged": g_conv,
        "gridmg_gspmd_ms_per_step": round(g_ms, 1),
    }), flush=True)


_BENCHES = {
    "circulant": lambda: bench_circulant(),
    "spmv": lambda: bench_spmv(),
    "spmv64": lambda: bench_spmv(64),
    "spmv_tet": lambda: bench_spmv_tet(),
    "wave_implicit": lambda: bench_wave_implicit_both(),
    "wave_implicit32": lambda: bench_wave_implicit(32, pc="gridmg"),
    "wave_implicit64": lambda: bench_wave_implicit(64, pc="gridmg"),
    "ladder_ktetra2": lambda: bench_fixture_ladder(),
    "ladder_top": lambda: bench_ladder_top(),
    "ladder_kershaw2": lambda: bench_fixture_ladder(
        "3DKershaw/Kershaw2.med", "kershaw2med", K1=10, K2=40),
    "ladder_tetra6": lambda: bench_fixture_ladder(
        "3DTetrahedra/mesh_tetra_6.med", "tetra6med", K1=3, K2=9),
    "transport_implicit": lambda: bench_transport_implicit(),
    "transport_fixture": lambda: bench_transport_fixture(),
    "diffusion_implicit": lambda: bench_diffusion_implicit(),
    "wave_dct_direct": lambda: bench_wave_dct_direct(),
    "wave_ilu": lambda: bench_wave_ilu(32),
    "wave_explicit": lambda: bench_wave_explicit(),
    "pc_iterations": lambda: bench_pc_iterations(),
    "scale_distributed": lambda: bench_scale_distributed(),
    "scale_distributed48": lambda: bench_scale_distributed(48),
}


# metric-name prefix each bench produces — used to PURGE a bench's stale
# results from a merged artifact when a re-run of that bench fails (an error
# record alone would otherwise leave the old number presenting as current)
_BENCH_METRIC_PREFIX = {
    "circulant": "circulant_pc_applies_per_s",
    "spmv": "spmv_gnnz_per_s_kershaw32",
    "spmv64": "spmv_gnnz_per_s_kershaw64",
    "spmv_tet": "spmv_gnnz_per_s_tet",
    "wave_implicit": "wave_implicit_step_ms_kershaw16",
    "wave_implicit32": "wave_implicit_step_ms_kershaw32",
    "wave_implicit64": "wave_implicit_step_ms_kershaw64",
    "ladder_ktetra2": "wave_implicit_step_ms_ktetra2",
    "ladder_top": "wave_implicit_step_ms_kershawtet50",
    "ladder_kershaw2": "wave_implicit_step_ms_kershaw2med",
    "ladder_tetra6": "wave_implicit_step_ms_tetra6med",
    "transport_implicit": "transport_implicit_step_ms_100cubed",
    "transport_fixture": "transport_implicit_step_ms_kershaw2med",
    "diffusion_implicit": "diffusion_implicit_step_ms",
    "wave_dct_direct": "wave_dct_direct_us_per_step",
    "wave_ilu": "wave_ilu0_step_ms",
    "wave_explicit": "wave_explicit_step_us",
    "pc_iterations": "wave_implicit_gmres_iters_by_pc",
    "scale_distributed": "wave_implicit_dist_kershaw32",
    "scale_distributed48": "wave_implicit_dist_kershaw48",
}


def main(out_path: str | None = None, only: list[str] | None = None):
    """Usage: python bench_suite.py [out.json] [bench1,bench2,...]

    With a subset, results MERGE into an existing out.json by metric name
    (the full suite can exceed a single process's time budget)."""
    from circulantpreconditioner_tpu.utils import enable_compile_cache

    enable_compile_cache()
    results = []
    failed = []
    for name, fn in _BENCHES.items():
        if only and name not in only:
            continue
        try:
            rec = fn()
        except Exception as e:  # keep the suite going; record the failure
            rec = {"metric": f"{name}_ERROR", "error": str(e)[:200]}
            failed.append(name)
        rec["device"] = jax.devices()[0].device_kind
        print(json.dumps(rec), flush=True)
        results.append(rec)
    if out_path:
        import datetime
        import os

        payload = {
            "date": datetime.date.today().isoformat(),
            "device": str(jax.devices()[0]),
            "jax": jax.__version__,
            "methodology": "differenced device chains, min over reps",
            "results": results,
        }
        if only and os.path.exists(out_path):
            with open(out_path) as f:
                old = json.load(f)
            merged = {r["metric"]: r for r in old.get("results", [])}
            for name in failed:  # drop stale evidence for failed benches
                pref = _BENCH_METRIC_PREFIX.get(name, name)
                for k in [k for k in merged if k.startswith(pref)]:
                    del merged[k]
            for name in only:  # a successful re-run clears its error record
                if name not in failed:
                    merged.pop(f"{name}_ERROR", None)
            merged.update({r["metric"]: r for r in results})
            payload["results"] = list(merged.values())
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--scale-worker":
        _scale_worker(int(sys.argv[2]), int(sys.argv[3]))
    else:
        main(sys.argv[1] if len(sys.argv) > 1 else None,
             sys.argv[2].split(",") if len(sys.argv) > 2 else None)
