"""Profiling & observability — the reference's PetscTime/-log_view analog
(SURVEY.md §5).

- `timed`: wall-clock context manager with block_until_ready semantics.
- `trace`: jax.profiler trace context (view in TensorBoard / Perfetto).
- `StepMetrics`: per-step structured metrics (JSON-lines), replacing the
  reference's printf diagnostics (solve cpu time, KSP iterations, residual —
  TransportEquation_..._impl_mpi.cxx:131-148) with machine-readable records.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import jax


@contextlib.contextmanager
def timed(result: dict, key: str):
    """`with timed(d, "solve"): ...` → d["solve"] = seconds (device-synced)."""
    t0 = time.perf_counter()
    yield
    # sync so the measured interval covers device work dispatched inside
    jax.effects_barrier()
    result[key] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(logdir: str = "/tmp/jax_trace"):
    """Capture a jax.profiler trace around a code block."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@dataclass
class StepMetrics:
    """Append-only JSON-lines metrics sink."""

    path: str | None = None
    records: list[dict] = field(default_factory=list)

    def log(self, **kv) -> dict:
        rec = dict(ts=time.time(), **kv)
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def summary(self) -> dict:
        import numpy as np

        out: dict = {"steps": len(self.records)}
        for key in ("solve_s", "iters", "resnorm"):
            vals = [r[key] for r in self.records if key in r]
            if vals:
                out[key] = {"median": float(np.median(vals)), "max": float(np.max(vals))}
        return out
