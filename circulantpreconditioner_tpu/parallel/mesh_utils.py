"""Device-mesh helpers: the replacement for the reference's MPI communicator
world (PETSC_COMM_WORLD). One logical axis is enough for the row-partitioned /
slab-decomposed layouts this framework uses (SURVEY.md §2.6); the pencil
solver takes a plain 2D mesh. The cards of one host reach each other at the
same rate (NVLink, all to all), so a mesh follows the algorithm alone."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def device_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def device_mesh_2d(shape: tuple[int, int], axes: tuple[str, str] = ("z", "y")) -> Mesh:
    """2D device mesh (p, q) for pencil decompositions, over the first p·q
    devices."""
    p, q = shape
    devs = jax.devices()
    if p * q > len(devs):
        raise ValueError(f"requested {p * q} devices, have {len(devs)}")
    return Mesh(np.array(devs[: p * q]).reshape(p, q), axes)


def shard_on_axis(mesh: Mesh, axis_name: str, array_axis: int, ndim: int) -> NamedSharding:
    spec = [None] * ndim
    spec[array_axis] = axis_name
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
