"""Test configuration: by default run on CPU with 8 virtual devices.

Mirrors the reference's ctest strategy of simulating the cluster with
multi-process MPI on one machine (/root/reference/tests/CMakeLists.txt:67-74):
here the "fake cluster" is XLA's host-platform device count, so sharding /
collective code paths compile and execute exactly as they would across
several cards. Must run before jax is imported anywhere.

When JAX_PLATFORMS names another platform (e.g. `JAX_PLATFORMS=cuda python
-m pytest -m gpu tests/`), the tests run there instead; tests marked `gpu`
decide inside the test whether a card is present.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Oracle tests compare against SciPy in double precision.
jax.config.update("jax_enable_x64", True)
