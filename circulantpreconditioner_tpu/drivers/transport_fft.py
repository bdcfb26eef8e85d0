"""TransportEquationFFT_SphericalExplosion driver analog.

Reference: tests/TransportEquationFFT_SphericalExplosion_impl_mpi.cxx —
implicit transport on a cartesian grid, each step solved DIRECTLY by the
circulant FFT solver; a=(1,0,...), cfl=1e3/dim, tmax=0.05, stationarity 1e-5.

    python -m circulantpreconditioner_tpu.drivers.transport_fft 100 100 100
"""

from __future__ import annotations

import numpy as np

from circulantpreconditioner_tpu.drivers.common import base_parser, build_mesh, make_output_cb, setup_dtype, chunk_of
from circulantpreconditioner_tpu.models import TransportEquation, run_time_loop


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--method", choices=["auto", "fft", "matmul"], default="auto")
    p.add_argument("--shard", choices=["none", "slab", "pencil"], default="none",
                   help="distributed solve over the device mesh (the _mpi analog)")
    args = p.parse_args(argv)
    dtype = setup_dtype(args)
    args.periodic = True  # the FFT direct solve is inherently periodic
    mesh = build_mesh(args)
    if not mesh.is_structured:
        raise SystemExit("transport_fft requires a cartesian mesh (use transport_implicit)")
    dim = mesh.dim
    velocity = [0.0] * dim
    velocity[0] = 1.0  # reference: vitesseTransport=(1,0,0)
    model = TransportEquation(mesh, velocity, cfl=args.cfl or 1e3 / dim, dtype=dtype)
    print(f"-- FFT transport: mesh {mesh.name}, dt={model.dt:.4g}, "
          f"lambdas={model.fft_operator.lambdas_zyx}")
    if args.shard != "none":
        import jax
        import jax.numpy as jnp

        from circulantpreconditioner_tpu.parallel import (
            PencilCirculantSolver,
            SlabCirculantSolver,
            device_mesh,
            device_mesh_2d,
        )

        op = model.fft_operator
        if dim != 3:
            raise SystemExit("--shard needs a 3D grid")
        if args.shard == "slab":
            dm = device_mesh(args.devices)
            solver = SlabCirculantSolver.from_operator(op, dm)
        else:
            n = args.devices or len(jax.devices())
            pq = tuple(args.pq) if args.pq else (max(n // 2, 1), 2 if n >= 2 else 1)
            dm = device_mesh_2d(pq)
            solver = PencilCirculantSolver.from_operator(op, dm)
        print(f"-- sharded over {dm.shape} devices ({args.shard})")
        dnorm = jax.jit(lambda a, b: jnp.linalg.norm(a - b))

        def step(u):
            u1 = solver.solve(u)
            return u1, dnorm(u1, u)

        u0 = solver.shard(np.asarray(model.initial_state()).reshape(op.shape_zyx))
    else:
        step = model.fft_stepper(method=args.method)
        u0 = model.initial_state()
    res = run_time_loop(
        step, u0, model.dt, tmax=args.tmax, ntmax=args.ntmax,
        precision=args.precision, output_freq=args.output_freq,
        chunk=chunk_of(args),
        on_output=make_output_cb(args, mesh, prefix="temperature"),
    )
    u = np.asarray(res.state)
    print(f"\nEnd at it={res.iterations} t={res.time:.6g} stationary={res.stationary}")
    print(f"temperature range [{u.min():.4f}, {u.max():.4f}], mean {u.mean():.4f}")
    if res.step_seconds:
        print(f"median solve wall: {np.median(res.step_seconds)*1e3:.3f} ms")
    return res


if __name__ == "__main__":
    main()
