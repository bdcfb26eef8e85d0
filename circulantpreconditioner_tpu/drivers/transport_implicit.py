"""TransportEquation_SphericalExplosion implicit GMRES driver analog.

Reference: tests/TransportEquation_SphericalExplosion_impl_mpi.cxx — implicit
transport solved with GMRES + PCNONE (default 100³ cube), per-solve wall time
printed. Here the preconditioner is selectable, including the completed
circulant projection PC for unstructured meshes.

    python -m circulantpreconditioner_tpu.drivers.transport_implicit 100 100 100
    python -m ... --mesh-family kershaw 8 8 8 --pc circulant
"""

from __future__ import annotations

import numpy as np

from circulantpreconditioner_tpu.drivers.common import base_parser, build_mesh, make_output_cb, setup_dtype, chunk_of
from circulantpreconditioner_tpu.models import TransportEquation, run_time_loop


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--pc", choices=["none", "jacobi", "circulant"], default="none")
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--atol", type=float, default=1e-5)
    p.add_argument("--maxits", type=int, default=1000)
    args = p.parse_args(argv)
    dtype = setup_dtype(args)
    mesh = build_mesh(args)
    dim = mesh.dim
    velocity = [0.0] * dim
    velocity[0] = 1.0
    model = TransportEquation(mesh, velocity, cfl=args.cfl or 1e3 / dim, dtype=dtype)

    M = None
    side = "left"
    if args.pc == "jacobi":
        from circulantpreconditioner_tpu.solvers import preconditioners as pcs

        d = model.divergence.diagonal() + 1.0
        import jax.numpy as jnp

        import jax

        dinv = 1.0 / d
        M = jax.tree_util.Partial(pcs._diag_apply, dinv)
    elif args.pc == "circulant":
        if mesh.is_structured:
            # periodic grid: the exact inverse (1 GMRES iteration).
            # wall/Neumann grid: the periodic circulant differs from the
            # operator only on the boundary-face layer — measured 2 GMRES
            # iterations at any size (vs 19/121/250+ unpreconditioned at
            # 20/40/100³). This is the acceleration the reference project
            # was built to demonstrate (ToDo.md:1, PCSHELLFft_3D.cxx).
            # make_circulant_solver picks the fastest exact formulation for
            # the λ pattern (spectral collapse → ONE matmul for the
            # reference's axis-aligned velocity). Full float32 matmuls: at
            # the fast TF32 tier GMRES needs 11 iterations instead of 4
            # (H100, 100³).
            from circulantpreconditioner_tpu.ops.spectral_collapse import (
                make_circulant_solver,
            )

            op = model.fft_operator
            M = make_circulant_solver(op.shape_zyx, op.lambdas_zyx,
                                      dtype=dtype).as_preconditioner()
            side = "right"  # true-residual convergence (PC is approximate)
        else:
            import jax.numpy as jnp

            from circulantpreconditioner_tpu.solvers import preconditioners as pcs
            from circulantpreconditioner_tpu.solvers.circulant_pc import CirculantProjectionPC

            # additive two-level: projection-circulant coarse + Jacobi smoother
            # (the bare projection PC is rank-deficient; see circulant_pc.py)
            coarse = CirculantProjectionPC(mesh, model.velocity, model.dt, dtype=dtype)
            import jax

            dinv = 1.0 / (model.divergence.diagonal() + 1.0)
            M = pcs.additive(coarse.apply, jax.tree_util.Partial(pcs._diag_apply, dinv))
            side = "right"  # true-residual GMRES

    step = model.implicit_stepper(M=M, rtol=args.rtol, atol=args.atol, maxiter=args.maxits,
                                  side=side)
    print(f"-- implicit transport: mesh {mesh.name} ({mesh.n_cells} cells), "
          f"dt={model.dt:.4g}, pc={args.pc}")
    res = run_time_loop(
        step, model.initial_state(), model.dt, tmax=args.tmax, ntmax=args.ntmax,
        precision=args.precision, output_freq=args.output_freq,
        chunk=chunk_of(args),
        on_output=make_output_cb(args, mesh, prefix="temperature"),
    )
    u = np.asarray(res.state)
    its = [d["extras"][0] for d in res.diagnostics if d["extras"]]
    print(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
    print(f"temperature range [{u.min():.4f}, {u.max():.4f}]")
    if its:
        print(f"GMRES iterations per step: median {np.median(its):.0f}, max {np.max(its):.0f}")
    return res


if __name__ == "__main__":
    main()
