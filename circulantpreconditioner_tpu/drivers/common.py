"""Shared CLI plumbing for the driver executables.

The reference drivers take `[mesh.med | nx [ny [nz]]] [resultDir]` positional
args (e.g. tests/TransportEquationFFT_...cxx:183-225, domain [-0.5,0.5]^d).
Here: positional nx [ny [nz]] with the same default domain, plus options for
the unstructured families (--mesh-family hexa|tetra|kershaw|kershawtet or --msh FILE)
and output/checkpoint directories.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from circulantpreconditioner_tpu.io import save_checkpoint, write_vtk
from circulantpreconditioner_tpu.mesh import cartesian_mesh
from circulantpreconditioner_tpu.mesh.unstructured import (
    hex_mesh,
    kershaw_mesh,
    read_gmsh,
    tet_mesh,
)


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("n", nargs="*",
                   help="mesh.med|mesh.msh file, or nx [ny [nz]] (cartesian [-0.5,0.5]^d) "
                        "— same positional convention as the reference drivers")
    p.add_argument("--mesh-family", choices=["cartesian", "hexa", "tetra", "kershaw",
                                        "kershawtet"],
                   default="cartesian")
    p.add_argument("--msh", help="Gmsh .msh v2.2 file (overrides n / family)")
    p.add_argument("--periodic", action="store_true", help="periodic BCs (cartesian only)")
    p.add_argument("--kershaw-eps", type=float, default=0.3)
    p.add_argument("--tmax", type=float, default=0.05)
    p.add_argument("--ntmax", type=int, default=2_000_000)
    p.add_argument("--cfl", type=float, default=None)
    p.add_argument("--precision", type=float, default=1e-5,
                   help="stationarity threshold on ||dU||_2 (reference: 1e-5)")
    p.add_argument("--output-freq", type=int, default=1)
    p.add_argument("--chunk", type=int, default=None,
                   help="steps per device dispatch (lax.scan chunk; default "
                        "output-freq — keeps the hot loop device-resident "
                        "between outputs instead of paying host RTT per step; "
                        "1 = step-by-step host loop)")
    p.add_argument("--result-dir", default="./results")
    p.add_argument("--vtk", action="store_true", help="write VTK snapshots")
    p.add_argument("--med", action="store_true",
                   help="write a MED time series (Field::writeMED analog)")
    p.add_argument("--checkpoint-freq", type=int, default=0,
                   help="save (state,t,it) every N steps (0 = off)")
    p.add_argument("--f64", action="store_true", help="float64 state and solves")
    p.add_argument("--devices", type=int, default=None,
                   help="device count for --shard modes (default: all visible)")
    p.add_argument("--pq", type=int, nargs=2, default=None,
                   help="pencil device-mesh shape (p q)")
    return p


def build_mesh(args):
    if args.msh:
        from circulantpreconditioner_tpu.mesh.topology import recover_grid_topology

        mesh = read_gmsh(args.msh)
        recover_grid_topology(mesh)
        return mesh
    if args.n and not str(args.n[0]).lstrip("-").isdigit():
        from circulantpreconditioner_tpu.mesh import read_mesh

        return read_mesh(args.n[0])
    n = [int(v) for v in args.n] or [50, 50]  # reference default 50x50 square
    dim = len(n)
    bounds = ((-0.5, 0.5),) * max(dim, 3 if args.mesh_family != "cartesian" else dim)
    if args.mesh_family == "cartesian":
        return cartesian_mesh(((-0.5, 0.5),) * dim, n, periodic=args.periodic)
    n3 = (n + [n[-1]] * 3)[:3]
    if args.mesh_family == "hexa":
        return hex_mesh(bounds[:3], n3)
    if args.mesh_family == "tetra":
        return tet_mesh(bounds[:3], n3)
    if args.mesh_family == "kershawtet":
        # generated 3DKershawTetra analog (the reference ladder's top family)
        from circulantpreconditioner_tpu.mesh import kershaw_tet_mesh

        return kershaw_tet_mesh(bounds[:3], n3, eps=args.kershaw_eps)
    return kershaw_mesh(bounds[:3], n3, eps=args.kershaw_eps)


def setup_dtype(args):
    import jax
    import jax.numpy as jnp

    from circulantpreconditioner_tpu.utils import enable_compile_cache

    enable_compile_cache()
    if args.f64:
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    return jnp.float32


def make_output_cb(args, mesh, split=None, prefix="field"):
    os.makedirs(args.result_dir, exist_ok=True)
    med_path = os.path.join(args.result_dir, f"{mesh.name}_{prefix}.med")
    wrote_med = [False]

    def cb(it, t, U, extras):
        if args.vtk or getattr(args, "med", False):
            if split is not None:
                p, v = split(U)
                fields = {"pressure": p, "velocity": v}
            else:
                # sharded steppers carry grid-shaped state; writers take flat cells
                fields = {prefix: np.asarray(U).reshape(-1)}
            if args.vtk:
                write_vtk(os.path.join(args.result_dir, f"{mesh.name}_{prefix}_{it:06d}.vtk"),
                          mesh, fields, time=t)
            if getattr(args, "med", False):
                from circulantpreconditioner_tpu.io import write_med

                write_med(med_path, mesh, fields, time=t, it=it, append=wrote_med[0])
                wrote_med[0] = True
        if args.checkpoint_freq and it % args.checkpoint_freq == 0:
            save_checkpoint(os.path.join(args.result_dir, f"{mesh.name}_ckpt.npz"),
                            U, t, it)

    return cb


def chunk_of(args) -> int:
    """Steps per device dispatch: --chunk, default --output-freq."""
    c = args.chunk if args.chunk is not None else args.output_freq
    return max(int(c), 1)
