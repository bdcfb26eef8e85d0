"""Generic time loop mirroring the reference drivers' structure.

Reference loop shape (e.g. TransportEquationFFT_...cxx:107-137): step until
it ≥ ntmax, t > tmax, or stationarity ‖ΔU‖₂ < precision; log/save every
output_freq steps. Steps are jitted; the loop itself is host-side so drivers
can log and write output (the reference does the same — PETSc solves inside
a C while loop). For pure benchmarking use `scan_steps`, which keeps the
whole multi-step run on device with zero host round-trips.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class TimeLoopResult:
    state: jax.Array
    time: float
    iterations: int
    stationary: bool
    step_seconds: list[float] = field(default_factory=list)
    diagnostics: list[dict] = field(default_factory=list)


def run_time_loop(
    step: Callable,  # U -> (U_new, dnorm[, extra...])
    U0: jax.Array,
    dt: float,
    tmax: float = 0.05,
    ntmax: int = 2_000_000,
    precision: float = 1e-5,
    output_freq: int = 1,
    on_output: Callable | None = None,  # (it, t, U_host, extras) -> None
    log: Callable | None = print,
    chunk: int | None = None,
) -> TimeLoopResult:
    """chunk > 1 runs that many steps per host dispatch as ONE jitted
    lax.scan (device-resident between output points: no host round trip
    per step).
    Per-step dnorms still come back for the stationarity test; if it trips
    mid-chunk the loop stops with the chunk-end state (the extra steps past
    a stationary point are no-ops by definition). Drivers default to
    chunk=output_freq."""
    if chunk is not None and chunk > 1:
        return _run_time_loop_chunked(step, U0, dt, tmax=tmax, ntmax=ntmax,
                                      precision=precision, chunk=chunk,
                                      on_output=on_output, log=log)
    U = U0
    t = 0.0
    it = 0
    stationary = False
    result = TimeLoopResult(U, t, it, stationary)
    while it < ntmax and t <= tmax and not stationary:
        t0 = time.perf_counter()
        out = step(U)
        U_new, dnorm, *extras = out
        U_new = jax.block_until_ready(U_new)
        dt_wall = time.perf_counter() - t0
        U = U_new
        t += dt
        it += 1
        dn = float(jnp.asarray(dnorm).reshape(-1)[0])
        stationary = dn < precision
        # failure detection: implicit steppers return (.., iters, resnorm,
        # converged) — log and continue, like the reference's KSP reason
        # branch (WaveSystem_..._impl_seq.cxx:138-146)
        if len(extras) >= 3 and not bool(np.asarray(extras[2])):
            if log is not None:
                log(f"!! step {it}: linear solver did NOT converge "
                    f"(iters={int(np.asarray(extras[0]))}, "
                    f"residual={float(np.asarray(extras[1])):.3e})")
        if it % output_freq == 0 or it >= ntmax or stationary or t >= tmax:
            result.step_seconds.append(dt_wall)
            diag = {"it": it, "t": t, "dnorm": dn,
                    "extras": [np.asarray(e).tolist() for e in extras]}
            result.diagnostics.append(diag)
            if log is not None:
                log(f"-- step {it}, time {t:.6g}, dt {dt:.3g}, |dU| {dn:.3e}, "
                    f"solve wall {dt_wall*1e3:.3f} ms")
            if on_output is not None:
                on_output(it, t, np.asarray(U), extras)
    result.state = U
    result.time = t
    result.iterations = it
    result.stationary = stationary
    return result


def _run_time_loop_chunked(
    step: Callable,
    U0: jax.Array,
    dt: float,
    *,
    tmax: float,
    ntmax: int,
    precision: float,
    chunk: int,
    on_output: Callable | None,
    log: Callable | None,
) -> TimeLoopResult:
    """Device-resident variant: `chunk` steps per dispatch via lax.scan.
    Matches the reference hot loops (TransportEquationFFT_...cxx:107-137)
    run at device rate instead of host-RTT rate."""
    import functools

    @functools.lru_cache(maxsize=8)
    def make_runner(n: int):
        @jax.jit
        def run(U):
            def body(U, _):
                out = step(U)
                return out[0], (out[1], tuple(out[2:]))
            Uf, (dnorms, extras) = jax.lax.scan(body, U, None, length=n)
            return Uf, dnorms, extras
        return run

    U = U0
    t = 0.0
    it = 0
    stationary = False
    result = TimeLoopResult(U, t, it, stationary)
    while it < ntmax and t <= tmax and not stationary:
        n = min(chunk, ntmax - it, max(int((tmax - t) / dt) + 1, 1))
        t0 = time.perf_counter()
        U, dnorms, extras = make_runner(n)(U)
        U = jax.block_until_ready(U)
        dt_wall = time.perf_counter() - t0
        dnorms = np.asarray(dnorms).reshape(n, -1)[:, 0]
        it += n
        t += n * dt
        hit = np.nonzero(dnorms < precision)[0]
        stationary = hit.size > 0
        dn = float(dnorms[hit[0]] if stationary else dnorms[-1])
        last_extras = [np.asarray(e)[-1] for e in extras]
        if len(last_extras) >= 3 and not bool(last_extras[2]):
            if log is not None:
                log(f"!! step {it}: linear solver did NOT converge "
                    f"(iters={int(last_extras[0])}, "
                    f"residual={float(last_extras[1]):.3e})")
        result.step_seconds.append(dt_wall / n)
        diag = {"it": it, "t": t, "dnorm": dn,
                "extras": [e.tolist() for e in last_extras]}
        result.diagnostics.append(diag)
        if log is not None:
            log(f"-- step {it}, time {t:.6g}, dt {dt:.3g}, |dU| {dn:.3e}, "
                f"wall/step {dt_wall / n * 1e3:.3f} ms ({n}-step device chunk)")
        if on_output is not None:
            on_output(it, t, np.asarray(U), last_extras)
    result.state = U
    result.time = t
    result.iterations = it
    result.stationary = stationary
    return result


def scan_steps(step: Callable, U0: jax.Array, n_steps: int):
    """Run `n_steps` applications of `step` fully on device via lax.scan
    (benchmark path — no host sync per step). `step` must return
    (U_new, dnorm[, ...]); extras beyond dnorm are discarded."""

    @jax.jit
    def run(U0):
        def body(U, _):
            out = step(U)
            return out[0], out[1]

        Uf, dnorms = jax.lax.scan(body, U0, None, length=n_steps)
        return Uf, dnorms

    return run(U0)
