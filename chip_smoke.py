"""Run the solver framework's main path once on a GPU and check what it computes.

    python chip_smoke.py           # phases A-E on one card
    python chip_smoke.py --four    # the distributed paths on four cards, one process

Every phase goes through a user entry point: a driver's ``main(argv)`` in
``circulantpreconditioner_tpu/drivers/``, or the model API for phase B.  Each
prints one ``phase`` line with the compile seconds (first step minus a warm
step), the warm milliseconds per step (host clock around work that ends in
``block_until_ready``), the GMRES iterations where there are any, the relative
error or residual against a float64 NumPy/SciPy reference built on the host
from the same assembled operator or the same spectrum, its tolerance, and
``peak_bytes_in_use`` of device 0.

A missed tolerance or an unconverged solve raises, and no phase's exception is
caught.  Only after every phase passed does the last line of stdout carry the
verdict ``{"ok": true, "device": {...}}``.  With no GPU the script exits
non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Tolerances.  The drivers keep float32 state, and their GMRES solves stop at
# rtol = atol = 1e-5 (the reference's KSP settings).
#  - State vs a float64 solve of the same spectrum or operator: a float32
#    direct solve or explicit step is exact up to float32 rounding (~1e-7
#    relative per step), so the two must agree to 1e-5.
TOL_STATE = 1e-5
#  - Residual ||(I+D)x - b|| / ||b|| in float64 of the float32 answer: GMRES
#    stops at 1e-5, and float32 arithmetic alone leaves a residual of order
#    eps * ||I+D|| at the drivers' cfl (the exact DCT/DST direct solve, state
#    error 1e-7, measured 2.1e-5 at 64³ on an H100), so residuals are held
#    to 1e-4.  A TF32 matmul tier lands at 2e-2 and fails it.
TOL_RESIDUAL = 1e-4

def nvidia_smi_line() -> str:
    """Card name and power limit as nvidia-smi reports them (a child process
    that never touches JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (FileNotFoundError, subprocess.CalledProcessError) as e:
        raise SystemExit(f"chip_smoke: nvidia-smi failed ({e}); no GPU") from e
    return out.stdout.strip()


def require_gpu(devices, count: int):
    """Refuse to run anywhere but on `count` GPUs."""
    if not devices or devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (devices: {devices})")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: need {count} GPUs, found {len(devices)}")


def _peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _check(what: str, value: float, tol: float):
    if not np.isfinite(value) or value > tol:
        raise RuntimeError(f"{what} = {value:.3e} exceeds its tolerance {tol:.0e}")


def _converged_its(*results) -> list[int]:
    """GMRES iterations of every step; raises if any step did not converge."""
    its = []
    for res in results:
        for d in res.diagnostics:
            iters, _resnorm, converged = d["extras"]
            if not converged:
                raise RuntimeError(f"GMRES did not converge at step {d['it']} "
                                   f"({iters} iterations)")
            its.append(int(iters))
    return its


def _timing(first, timed) -> tuple[float, float]:
    """(compile seconds, warm ms per step): the first step of `first` pays
    the compilation; the later steps of `timed` are warm."""
    warm = float(np.median(timed.step_seconds[1:]))
    return max(first.step_seconds[0] - warm, 0.0), warm * 1e3


def _report(phase: str, **rec) -> dict:
    rec["peak_bytes_in_use"] = _peak_bytes()
    print(f"phase {phase} " + json.dumps(rec), flush=True)
    return rec


def _mesh(argv):
    """The mesh a driver builds from the same positional arguments."""
    from circulantpreconditioner_tpu.drivers.common import base_parser, build_mesh

    return build_mesh(base_parser("").parse_known_args(argv)[0])


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _residual(A, x, b) -> float:
    """||A x - b|| / ||b|| in float64 on the host."""
    x = np.asarray(x, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


def _identity_plus(D):
    """float64 SciPy I + D from the model's assembled divergence."""
    import scipy.sparse as sp

    D64 = D.to_scipy().astype(np.float64)
    return (sp.identity(D64.shape[0], format="csr") + D64).tocsr()


def transport_reference(u0, model) -> np.ndarray:
    """One implicit transport step on the periodic grid in float64:
    rfftn -> divide by the closed-form upwind spectrum -> irfftn."""
    from scipy import fft as sfft

    shape = tuple(reversed(model.mesh.structured_shape))  # zyx, x fastest
    lam_xyz = [a * model.dt / h for a, h in zip(model.velocity, model.mesh.spacing)]
    lam = np.ones(shape[:-1] + (shape[-1] // 2 + 1,), np.complex128)
    for ax, (n, l) in enumerate(zip(shape, reversed(lam_xyz))):
        k = np.arange(lam.shape[ax])
        bshape = [1] * len(shape)
        bshape[ax] = k.size
        lam = lam + l * (1.0 - np.exp(-2j * np.pi * k / n)).reshape(bshape)
    u = np.asarray(u0, np.float64).reshape(shape)
    return sfft.irfftn(sfft.rfftn(u) / lam, s=shape).reshape(-1)


# --- phases ---------------------------------------------------------------


def phase_a(n: int = 100, steps: int = 5, result_dir: str = "results") -> dict:
    """transport_fft, a=(1,0,0), on the reference's largest registered grid."""
    from circulantpreconditioner_tpu.drivers import transport_fft
    from circulantpreconditioner_tpu.models import TransportEquation

    grid = [str(n)] * 3
    common = ["--tmax", "1e9", "--result-dir", result_dir]
    first = transport_fft.main(grid + ["--ntmax", "1"] + common)
    timed = transport_fft.main(grid + ["--ntmax", str(steps)] + common)
    model = TransportEquation(_mesh(grid + ["--periodic"]), (1.0, 0.0, 0.0),
                              cfl=1e3 / 3)
    err = _rel(first.state, transport_reference(model.initial_state(), model))
    _check("phase A step-1 state rel. L2", err, TOL_STATE)
    compile_s, warm_ms = _timing(first, timed)
    return _report("A", compile_s=compile_s, warm_ms_per_step=warm_ms,
                   rel_l2=err, tol=TOL_STATE)


def phase_b(n: int = 256, steps: int = 3) -> dict:
    """Periodic transport with a general velocity through the model API: the
    full 3D transform runs (no spectral collapse)."""
    import jax

    from circulantpreconditioner_tpu.mesh import cartesian_mesh
    from circulantpreconditioner_tpu.models import TransportEquation

    mesh = cartesian_mesh(((-0.5, 0.5),) * 3, (n, n, n), periodic=True)
    model = TransportEquation(mesh, (1.0, 0.5, 0.25))
    step = model.fft_stepper()
    u0 = model.initial_state()
    u, walls, u1 = u0, [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        u, _dnorm = step(u)
        jax.block_until_ready(u)
        walls.append(time.perf_counter() - t0)
        if u1 is None:
            u1 = np.asarray(u)
    err = _rel(u1, transport_reference(u0, model))
    _check("phase B step-1 state rel. L2", err, TOL_STATE)
    warm = float(np.median(walls[1:]))
    return _report("B", compile_s=max(walls[0] - warm, 0.0),
                   warm_ms_per_step=warm * 1e3, rel_l2=err, tol=TOL_STATE)


def _implicit_phase(name, module, mesh_argv, pc_argv, model_of, steps, tol,
                    result_dir):
    """Shared body of the implicit phases: a 1-step run that is checked, a
    `steps`-step run that is timed, both through `module.main(argv)`."""
    argv = mesh_argv + pc_argv + ["--tmax", "1e9", "--result-dir", result_dir]
    first = module.main(argv + ["--ntmax", "1"])
    timed = module.main(argv + ["--ntmax", str(steps)])
    model = model_of(_mesh(mesh_argv))
    u0 = np.asarray(model.initial_state())
    res = _residual(_identity_plus(model.divergence), first.state, u0)
    _check(f"phase {name} step-1 residual", res, tol)
    its = _converged_its(first, timed) if first.diagnostics[0]["extras"] else None
    compile_s, warm_ms = _timing(first, timed)
    return _report(name, compile_s=compile_s, warm_ms_per_step=warm_ms,
                   gmres_its=its, residual=res, tol=tol)


def phase_c(n: int = 100, steps: int = 3, result_dir: str = "results") -> dict:
    """transport_implicit with the circulant PC: the spectral-collapse matmul."""
    from circulantpreconditioner_tpu.drivers import transport_implicit
    from circulantpreconditioner_tpu.models import TransportEquation

    return _implicit_phase(
        "C", transport_implicit, [str(n)] * 3, ["--pc", "circulant"],
        lambda mesh: TransportEquation(mesh, (1.0, 0.0, 0.0), cfl=1e3 / 3),
        steps, TOL_RESIDUAL, result_dir)


def _wave(mesh):
    from circulantpreconditioner_tpu.models import WaveSystem

    return WaveSystem(mesh, cfl=1e3 / 3)


def phase_d(n: int = 64, steps: int = 3, explicit_steps: int = 10,
            result_dir: str = "results") -> list[dict]:
    """Kershaw n³: implicit GMRES + grid V-cycle, and explicit stepping."""
    from circulantpreconditioner_tpu.drivers import wave_explicit, wave_implicit
    from circulantpreconditioner_tpu.models import WaveSystem

    argv = ["--mesh-family", "kershaw"] + [str(n)] * 3
    recs = [_implicit_phase("D-implicit", wave_implicit, argv, ["--pc", "gridmg"],
                            _wave, steps, TOL_RESIDUAL, result_dir)]

    res = wave_explicit.main(argv + ["--ntmax", str(explicit_steps), "--tmax", "1e9",
                                     "--result-dir", result_dir])
    model = WaveSystem(_mesh(argv), cfl=1.0 / 3)
    D = model.divergence.to_scipy().astype(np.float64)
    u = np.asarray(model.initial_state(), np.float64)
    for _ in range(explicit_steps):
        u = u - D @ u
    err = _rel(res.state, u)
    _check("phase D explicit state rel. L2", err, TOL_STATE)
    compile_s, warm_ms = _timing(res, res)
    recs.append(_report("D-explicit", compile_s=compile_s, warm_ms_per_step=warm_ms,
                        rel_l2=err, tol=TOL_STATE))
    return recs


def phase_d2(n: int = 64, steps: int = 3, result_dir: str = "results") -> dict:
    """Cartesian walls: the exact DCT/DST direct solve replaces GMRES."""
    from circulantpreconditioner_tpu.drivers import wave_implicit

    return _implicit_phase("D2", wave_implicit, [str(n)] * 3, ["--pc", "dctfft"],
                           _wave, steps, TOL_RESIDUAL, result_dir)


def phase_e(n: int = 50, steps: int = 2, result_dir: str = "results") -> dict:
    """Generated Kershaw-tetra top rung: the supercell stencil + grid V-cycle."""
    from circulantpreconditioner_tpu.drivers import wave_implicit

    return _implicit_phase("E", wave_implicit,
                           ["--mesh-family", "kershawtet"] + [str(n)] * 3,
                           ["--pc", "gridmg"], _wave, steps, TOL_RESIDUAL, result_dir)


def run_one_card(result_dir: str = "results") -> None:
    phase_a(result_dir=result_dir)
    phase_b()
    phase_c(result_dir=result_dir)
    phase_d(result_dir=result_dir)
    phase_d2(result_dir=result_dir)
    phase_e(result_dir=result_dir)


# --- four cards -----------------------------------------------------------


def _spread_check(devices, state_bytes: int):
    """Every card holds at least its share of the state: no path left the
    work on device 0 (which also keeps the host-assembled operator)."""
    peaks = [_peak_bytes(d) for d in devices]
    print("per-device peak_bytes_in_use " + json.dumps(peaks), flush=True)
    if None in peaks:  # the backend keeps no memory statistics
        return
    if min(peaks) < state_bytes / len(devices):
        raise RuntimeError(f"work not spread over the devices: peaks {peaks}, "
                           f"state {state_bytes} bytes")


def phase_four_transport(n: int = 256, steps: int = 3, result_dir: str = "results") -> list[dict]:
    """transport_fft --shard slab / pencil against the one-device solve."""
    import jax

    from circulantpreconditioner_tpu.drivers import transport_fft
    from circulantpreconditioner_tpu.models import TransportEquation

    ndev = len(jax.devices())
    grid = [str(n)] * 3
    common = ["--tmax", "1e9", "--result-dir", result_dir]
    shards = {"slab": [], "pencil": ["--pq", str(max(ndev // 2, 1)), "2" if ndev >= 2 else "1"]}
    sharded = {}
    for mode, extra in shards.items():
        first = transport_fft.main(grid + ["--shard", mode, "--ntmax", "1"] + extra + common)
        timed = transport_fft.main(grid + ["--shard", mode, "--ntmax", str(steps)]
                                   + extra + common)
        if len(first.state.sharding.device_set) != ndev:
            raise RuntimeError(f"{mode}: state lives on {first.state.sharding.device_set}")
        sharded[mode] = (first, timed)
    _spread_check(jax.devices(), first.state.nbytes)
    one = transport_fft.main(grid + ["--ntmax", "1"] + common)
    model = TransportEquation(_mesh(grid + ["--periodic"]), (1.0, 0.0, 0.0), cfl=1e3 / 3)
    ref = transport_reference(model.initial_state(), model)
    _check("one-device state rel. L2", _rel(one.state, ref), TOL_STATE)
    recs = []
    for mode, (first, timed) in sharded.items():
        err = _rel(first.state, one.state)
        _check(f"{mode} vs one-device rel. L2", err, TOL_STATE)
        compile_s, warm_ms = _timing(first, timed)
        recs.append(_report(f"four-{mode}", compile_s=compile_s, warm_ms_per_step=warm_ms,
                            rel_l2_vs_one_device=err, rel_l2_vs_f64=_rel(first.state, ref),
                            tol=TOL_STATE))
    return recs


def phase_four_wave(n: int = 32, result_dir: str = "results") -> dict:
    """wave_implicit --shard rows --pc circulant2l against the one-device run.
    Runs first, so the per-device peaks show how the rows path spread."""
    import jax

    from circulantpreconditioner_tpu.drivers import wave_implicit

    mesh_argv = ["--mesh-family", "kershaw"] + [str(n)] * 3
    argv = mesh_argv + ["--pc", "circulant2l", "--ntmax", "1", "--tmax", "1e9",
                        "--result-dir", result_dir]
    dist = wave_implicit.main(argv + ["--shard", "rows"])
    _spread_check(jax.devices(), np.asarray(dist.state).nbytes)
    one = wave_implicit.main(argv)
    model = _wave(_mesh(mesh_argv))
    A = _identity_plus(model.divergence)
    u0 = np.asarray(model.initial_state())
    res_d, res_1 = _residual(A, dist.state, u0), _residual(A, one.state, u0)
    _check("rows residual", res_d, TOL_RESIDUAL)
    _check("one-device residual", res_1, TOL_RESIDUAL)
    its_d, its_1 = _converged_its(dist)[0], _converged_its(one)[0]
    # the same two-level PC up to float32 roundoff and the distributed
    # circulant grid's rounding to multiples of the device count
    if abs(its_d - its_1) > max(2, its_1 // 10):
        raise RuntimeError(f"rows took {its_d} GMRES iterations, one device {its_1}")
    return _report("four-rows", gmres_its=its_d, gmres_its_one_device=its_1,
                   residual=res_d, residual_one_device=res_1, tol=TOL_RESIDUAL)


def run_four_cards(result_dir: str = "results") -> None:
    phase_four_wave(result_dir=result_dir)
    phase_four_transport(result_dir=result_dir)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the distributed paths, on four cards")
    args = p.parse_args(argv)
    count = 4 if args.four else 1
    print(nvidia_smi_line(), flush=True)

    import jax

    require_gpu(jax.devices(), count)
    devices = jax.devices()[:count]
    print(f"devices: {[d.device_kind for d in devices]}", flush=True)
    if args.four:
        run_four_cards()
    else:
        run_one_card()
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
