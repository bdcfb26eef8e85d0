"""Multi-host simulation: coordinated JAX processes over localhost — the
analog of the reference's `mpiexec -n 2` AND `-n 4` ctest tiers
(/root/reference/tests/CMakeLists.txt:67-74). Each process owns 2 virtual
CPU devices; the distributed solves run over the 2·n-device global mesh
and are gathered to process 0 (VecScatterCreateToZero analog)."""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_cluster(stage: str, timeout: int = 240, nprocs: int = 2):
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_ENABLE_X64"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nprocs), str(port), stage],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    assert any("OK process0" in o for o in outs)
    return outs


def test_two_process_slab_solve_and_gather():
    _run_cluster("slab")


def test_two_process_preconditioned_gmres():
    """GMRES + the distributed two-level circulant PC across 2 REAL
    processes (mpiexec -n 2 analog, reference tests/CMakeLists.txt:67-74):
    iteration count and solution must match the single-process solve."""
    outs = _run_cluster("pcgmres", timeout=420)
    assert any("pcgmres iters=" in o for o in outs)


def test_four_process_slab_solve_and_gather():
    """mpiexec -n 4 tier (reference tests/CMakeLists.txt:67-74): the slab
    FFT solve over 4 processes × 2 devices = 8-way decomposition."""
    _run_cluster("slab", timeout=360, nprocs=4)


def test_four_process_preconditioned_gmres():
    """mpiexec -n 4 tier for the preconditioned implicit wave solve: the
    halo SpMV, the distributed two-level circulant PC, and the psum GMRES
    reductions all cross REAL process boundaries 8 ways; iterations and
    solution must still match the single-process solve exactly."""
    outs = _run_cluster("pcgmres", timeout=600, nprocs=4)
    assert any("pcgmres iters=" in o for o in outs)


def test_two_process_window_gmres():
    """Halo clustered-window SpMV GMRES across 2 REAL processes — the
    unstructured-fixture analog of the pcgmres tier (reference MPI drivers
    on meshCube.med, tests/CMakeLists.txt:67-74)."""
    outs = _run_cluster("window", timeout=420)
    assert any("window halo=" in o for o in outs)


def test_four_process_window_gmres():
    """mpiexec -n 4 tier for the halo windowed SpMV GMRES."""
    outs = _run_cluster("window", timeout=600, nprocs=4)
    assert any("window halo=" in o for o in outs)
