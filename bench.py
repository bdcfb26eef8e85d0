"""Benchmark harness: circulant PC applies per second at 100³.

Flagship metric: circulant FFT PC applies per second (one PC apply == one
full direct solve of C x = b) on the reference's largest registered problem,
the 100³ transport grid with velocity a = (1,0,0)
(/root/reference/tests/CMakeLists.txt:42,
 TransportEquation_SphericalExplosion_impl_mpi.cxx:258-259). The baseline is
the same solve with SciPy's pocketfft (full 3D rfftn→divide→irfftn) on this
host's CPU — the stand-in for the reference's single-node PETSc/FFTW path,
which performs a full 3D FFT per solve regardless of the velocity
(/root/reference/src/FftLinearSolver_3D.c:166-190).

The measured solver is make_circulant_solver: for this λ pattern the exact
spectral collapse applies (Λ depends only on kx ⇒ the y/z transforms cancel;
ops/spectral_collapse.py) and the solve is ONE dense matmul along x.
The residual gate (1e-4, checked against the FULL 3D operator matvec) keeps
the comparison honest. `submetrics` record the staged full-3D DFT-matmul
pipeline on the same device.

Timing: warm-up, then repeated runs of one jitted `lax.fori_loop` chaining K
dependent solves, each ended by `block_until_ready`; the best run counts.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"submetrics"}.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def measure_scipy_baseline(n: int, lam: np.ndarray, steps: int = 20) -> float:
    """Solves/s of the SciPy CPU pipeline (rfftn → divide → irfftn)."""
    from scipy import fft as sfft

    rng = np.random.default_rng(0)
    u = rng.random((n, n, n)).astype(np.float32)
    lam_r = lam.astype(np.complex64)

    def solve(v):
        return sfft.irfftn(sfft.rfftn(v) / lam_r, s=v.shape).astype(np.float32)

    solve(u)  # warm up plan caches
    t0 = time.perf_counter()
    v = u
    for _ in range(steps):
        v = solve(v)
    dt = (time.perf_counter() - t0) / steps
    return 1.0 / dt


def main() -> None:
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.ops.circulant import (
        CirculantTransportOperator,
        np_eigenvalue_diagonal,
    )
    from circulantpreconditioner_tpu.ops.dft_matmul import MatmulCirculantSolver
    from circulantpreconditioner_tpu.ops.spectral_collapse import make_circulant_solver
    from circulantpreconditioner_tpu.utils import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]

    n = 100  # the reference's "gros calcul" grid (tests/CMakeLists.txt:42)
    h = 1.0 / n
    dt = (1e3 / 3) * (h / 6)
    lambdas_zyx = (0.0, 0.0, 1.0 * dt / h)
    op = CirculantTransportOperator.create((n, n, n), lambdas_zyx, jnp.float32)

    rng = np.random.default_rng(1)
    u0 = jnp.asarray(rng.random((n, n, n)).astype(np.float32) * 50 + 600)

    def rate_and_residual(solver, K=2000, reps=5):
        """Solves/s (best of `reps` timed K-solve chains after a warm-up)
        and the relative residual of one solve against the full 3D
        operator's stencil matvec."""
        @jax.jit
        def run_loop(u):
            return jax.lax.fori_loop(0, K, lambda i, v: solver.solve(v), u)

        jax.block_until_ready(run_loop(u0))
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run_loop(u0))
            times.append(time.perf_counter() - t0)
        u1 = solver.solve(u0)
        r = jax.jit(lambda a, b: jnp.linalg.norm(op.matvec(a) - b) / jnp.linalg.norm(b))(u1, u0)
        best = min(times)
        spread = (max(times) - best) / best
        return K / best, float(r), spread

    print(f"bench: flagship (spectral collapse) on {dev.device_kind}...",
          file=sys.stderr, flush=True)
    flagship = make_circulant_solver((n, n, n), lambdas_zyx, jnp.float32, precision="highest")
    solves_per_s, rel_res, spread = rate_and_residual(flagship, K=20000)
    print(f"bench: flagship {solves_per_s:.0f} solves/s, residual {rel_res:.2e}, "
          f"rep spread {spread:.1%}", file=sys.stderr, flush=True)
    if not rel_res < 1e-4:
        print(f"RESIDUAL CHECK FAILED: {rel_res}", file=sys.stderr)
        sys.exit(1)

    submetrics = {"flagship_rel_residual": round(rel_res, 8),
                  "flagship_rep_spread": round(spread, 4)}

    # full-3D DFT-matmul formulation for traceability (same device)
    staged = MatmulCirculantSolver.from_operator(op, precision="highest")
    v, r, _ = rate_and_residual(staged, reps=3)
    submetrics["staged_full3d_solves_per_s"] = round(v, 1)
    submetrics["staged_full3d_rel_residual"] = round(r, 8)
    print(f"bench: staged full-3D {v:.0f} solves/s (res {r:.1e})",
          file=sys.stderr, flush=True)

    lam_np = np_eigenvalue_diagonal((n, n, n), lambdas_zyx, rfft=True)
    baseline = measure_scipy_baseline(n, lam_np)
    print(f"bench: scipy baseline {baseline:.1f} solves/s", file=sys.stderr, flush=True)

    print(
        json.dumps(
            {
                "metric": "circulant_pc_applies_per_s_100cubed",
                "value": round(solves_per_s, 2),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / baseline, 2),
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "submetrics": submetrics,
            }
        )
    )


if __name__ == "__main__":
    main()
