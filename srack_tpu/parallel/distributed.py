"""Multi-host initialization (SURVEY.md §5 "jax.distributed").

The reference is a single OS process (SURVEY.md §2f); scaling past one
host is a build-side commitment.  Synthesis is data-parallel over voices,
so the multi-host story is deliberately thin:

* every host calls :func:`init_distributed` once, before touching devices;
* ``make_mesh()`` then builds a mesh over the GLOBAL device list
  (``jax.devices()`` spans processes after initialization) -- batch-axis
  shardings place voices on local devices, and the only collectives
  (mix-bus ``psum``, training-loss reductions) ride the intra-host links
  within a host and the network across hosts, inserted by XLA from the
  same ``NamedSharding`` annotations that drive the single-host farm;
* per-voice state never crosses hosts: the per-sample recurrence is
  device-local by design (SURVEY.md §5 long-context), so the network
  carries only reduced scalars/buses, never the hot path.

Validated by a two-process localhost CPU test
(tests/test_distributed.py; gloo cross-process collectives).  See
docs/ARCHITECTURE.md ("Multi-host") for the multi-host deployment recipe.
"""

from __future__ import annotations

from typing import Optional

import jax


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None,
                     **kwargs) -> dict:
    """Initialize the multi-process JAX runtime and report the topology.

    Thin wrapper over ``jax.distributed.initialize``: under managed
    launchers (SLURM, Open MPI, cloud pod schedulers) every argument
    auto-detects from the environment and ``init_distributed()`` is all a
    worker needs;
    otherwise pass ``coordinator_address="host:port"``, ``num_processes``
    and this worker's ``process_id`` explicitly.

    Call once per process, before any other JAX API touches devices.
    After it returns, ``jax.devices()`` is the GLOBAL accelerator list and
    :func:`srack_tpu.parallel.make_mesh` builds cross-host meshes from it.

    Returns ``{"process_id", "process_count", "global_devices",
    "local_devices"}``.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
        **kwargs)
    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
    }


def is_multiprocess() -> bool:
    return jax.process_count() > 1
