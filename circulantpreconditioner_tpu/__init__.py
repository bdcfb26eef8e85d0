"""circulantpreconditioner_tpu — FFT/circulant-preconditioned FV solver framework (JAX, NVIDIA GPUs).

A brand-new JAX/XLA/Pallas implementation of the capabilities of
ndjinga/CirculantPreconditioner (reference mounted at /root/reference):

- finite-volume upwind operators for the linear transport equation and the
  linear wave system on structured and unstructured meshes
  (reference: src/TransportEquation.cxx, src/WaveSystem.cxx),
- a circulant / block-circulant FFT direct solver
  (reference: src/FftLinearSolver_3D.c),
- matrix-free Krylov solvers (GMRES/CG/BiCGStab) with pluggable
  preconditioners, including the circulant FFT preconditioner applied through
  an unstructured→cartesian projection
  (reference: src/PCSHELLFft_3D.cxx — left unfinished there, completed here),
- multi-device scaling via jax.sharding: slab-decomposed distributed 3D FFT
  with all_to_all transposes and row-partitioned SpMV with halo exchange
  (reference: PETSc MPI row partitioning + FFTW-MPI).

Everything on the compute path is jittable; spectra/plans are cached on device.
"""

__version__ = "0.1.0"

# NumPy's MADV_HUGEPAGE makes first-touch page faults pathologically slow on
# this kernel (6.18.x: ~8 MB/s vs ~2 GB/s without — 250×), which dominated
# every host-side path (mesh loads, assembly, D2H buffers). Runtime switch;
# NUMPY_MADVISE_HUGEPAGE=0 in the environment achieves the same before import.
try:  # pragma: no cover - numpy-version dependent private API
    import numpy as _np

    _np._core.multiarray._set_madvise_hugepage(False)
except Exception:
    pass

from circulantpreconditioner_tpu.ops.circulant import (  # noqa: F401
    CirculantTransportOperator,
    transport_column,
    transport_spectrum,
    eigenvalue_diagonal,
)
