"""Device-mesh utilities for multi-chip render farms and training.

The reference has no distributed execution at all (SURVEY.md §2f); scaling
out is a build-side design: independent voices/patches are data-parallel, so
the natural layout is a mesh over the batch axis with XLA inserting
collectives only where renders are reduced (mix busses, losses, gradients).
The per-sample recurrence stays device-local (time cannot be split across
devices for feedback paths -- SURVEY.md §5 long-context).
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None,
              axis_names: Sequence[str] = ("dp", "vp")) -> Mesh:
    """Build a mesh over available devices.

    With two axis names the device count is factored as evenly as possible
    (e.g. 8 -> 4x2), giving a 2-D mesh: ``dp`` for independent patches /
    gate-lanes, ``vp`` for voices within an ensemble (the axis mix busses
    and gradient reductions ride).
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        a = 1
        for cand in range(int(math.isqrt(n)), 0, -1):
            if n % cand == 0:
                a = cand
                break
        shape = (n // a, a)
    mesh_devices = np.asarray(devices).reshape(shape)
    return Mesh(mesh_devices, axis_names[: len(shape)])


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a leading batch axis over every mesh axis (flattened)."""
    return NamedSharding(mesh, P(mesh.axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Place a pytree whose leaves have a leading batch axis onto the mesh,
    batch axis split over all mesh axes.

    Multi-process meshes (after ``parallel.init_distributed``): every
    process holds the full host array and contributes its addressable
    shards -- a plain ``device_put`` onto a cross-process sharding is
    illegal, so the leaves go through ``make_array_from_callback``.
    """
    sh = batch_sharding(mesh)
    if jax.process_count() > 1:
        def place(a):
            a = np.asarray(a)
            return jax.make_array_from_callback(
                a.shape, sh, lambda idx, a=a: a[idx])
        return jax.tree.map(place, tree)
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)
