"""srack_tpu — a batched modular synthesis framework on JAX.

A ground-up JAX/XLA rebuild of the capabilities of the s-rack modular
softsynth (reference mounted at /root/reference): patch graphs of
oscillators, filters, envelopes, sequencers, mixers and effects are compiled
into a single fused program where per-sample feedback becomes ``lax.scan``
carries, voices batch with ``vmap``, and render farms shard over device
meshes with ``jax.sharding``.

Quick start::

    import srack_tpu as st

    cfg = st.AudioConfig(sample_rate=48000, channels=1)
    p = st.Patch(cfg)
    osc = p.add("Oscillator", val=0.0)       # 440 Hz
    p.connect(osc, "Sine", p.output, 0)
    audio, probes, state = st.render(p, 48000)
"""

from .config import AudioConfig
from .patch import Patch, ModuleHandle
from .planner import plan_execution
from .compiler import CompiledPatch, compile_patch, migrate_state
from .engine import (
    render,
    render_stream,
    render_batch,
    render_many,
    render_long,
    stack_params,
    replicate_params,
)
from .modules import CATALOG, ModuleDef
from .modules import register as register_module
from .modules import unregister as unregister_module
from .rt import PlayStats, paced_consume, play
from . import io, utils, parallel, presets

__version__ = "0.1.0"

__all__ = [
    "AudioConfig",
    "Patch",
    "ModuleHandle",
    "plan_execution",
    "CompiledPatch",
    "compile_patch",
    "migrate_state",
    "render",
    "render_stream",
    "render_batch",
    "render_many",
    "render_long",
    "stack_params",
    "replicate_params",
    "CATALOG",
    "ModuleDef",
    "register_module",
    "unregister_module",
    "PlayStats",
    "paced_consume",
    "play",
]
