"""Batch render farm: thousands of voices/patches over a device mesh.

BASELINE config 5: independent randomized patches of one topology rendered
in parallel for dataset generation.  Voices are pure data parallelism --
the hot path has zero cross-device traffic; audio is gathered (or mix-bussed
with a ``psum``) only at collection (SURVEY.md §2f).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..compiler import compile_patch
from ..patch import Patch, ModuleHandle
from .mesh import make_mesh, shard_batch


def render_farm(patch: Patch, n_samples: int, *, params: dict,
                mesh=None, state: Optional[dict] = None, key=None,
                drivers=None, mixdown: bool = False,
                probes: Sequence = ()):
    """Render a sharded batch of voices.

    ``params`` carries a leading voice axis on every leaf; it is sharded
    over all mesh axes.  With ``mixdown=True`` the per-voice audio is summed
    into one ``[channels, n]`` mix bus -- a ``psum`` across the mesh (the
    only collective synthesis needs).
    """
    if mesh is None:
        mesh = make_mesh()
    compiled = compile_patch(patch, probes=probes)
    v = jax.tree.leaves(params)[0].shape[0]

    params = shard_batch(params, mesh)
    if state is None:
        state = compiled.init_state()
        state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                             state)
    state = shard_batch(state, mesh)
    if key is None:
        key = jax.random.PRNGKey(0)
    elif isinstance(key, int):
        key = jax.random.PRNGKey(key)
    keys = shard_batch(jax.random.split(key, v), mesh)

    drv = {}
    if drivers:
        for module, arr in drivers.items():
            mid = module.id if isinstance(module, ModuleHandle) else module
            drv[mid] = arr
    drv = shard_batch(drv, mesh)

    vmapped = compiled._get_fn(int(n_samples), batched=True,
                               engine=compiled.auto_engine(batched=True))
    # each device renders its own voice shard: a Pallas kernel is not
    # SPMD-partitionable, so without shard_map XLA would gather the batch
    # and run the whole farm on every device
    bspec = P(mesh.axis_names)

    def local(p, s, k, d):
        audio, probe_ys, final_state = vmapped(p, s, k, d)
        if mixdown:
            audio = jax.lax.psum(audio.sum(axis=0), mesh.axis_names)
        return audio, probe_ys, final_state

    # check_vma=False: pallas_call's outputs carry no varying-axes type
    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(bspec, bspec, bspec, bspec),
        out_specs=(P() if mixdown else bspec, bspec, bspec),
        check_vma=False)
    return jax.jit(sharded)(params, state, keys, drv)
