"""Whole-patch voice render in the voice-kernel shell.

The scan engine (compiler.py) is correct everywhere but runs one XLA loop
iteration per sample.  For "register-friendly" patches (oscillators,
filters, envelopes, VCAs, mixers, math, sequencers) the whole per-sample
step -- the compiler's ``_sample_step``, the same module code -- runs
inside one kernel (ops/shell.py) with every module's state in registers,
so the only memory traffic is hoisted noise/driver lanes in and rendered
audio out.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..modules.base import CV_DTYPE
from . import shell

# module types whose per-sample step is pure register math (no per-voice
# table gathers, no ragged delay lines).  The sequencers qualify because
# their table reads are select trees over the carried step counter
# (ops/basic.table_lookup), not gathers.
REGISTER_TYPES = frozenset({
    "Oscillator", "Noise", "Input", "Moog Filter", "ADSR", "VCA",
    "Mono Mixer", "Add", "Subtract", "Multiply", "Non-Linear", "Output",
    "Grid Sequencer", "Pattern Sequencer",
})


def eligible(compiled) -> bool:
    """Can this compiled patch run in the voice-kernel shell?  (Buffer-
    feedback compat mode runs via :func:`make_fused_render_buffer`.)"""
    if compiled.cfg.exact or compiled.probes:
        return False
    return all(mdef.type_name in REGISTER_TYPES or mdef.register_safe
               for mdef, _, _ in compiled.instances.values())


def default_unroll(compiled) -> int:
    # big patches inline every unrolled copy of a big body: the sequencer
    # preset (~30 modules) took 163 s to compile at unroll 4 on an H100
    return 8 if len(compiled.instances) <= 16 else 2


def channel_keys(compiled):
    return [f"out{c}" for c in range(compiled.cfg.channels)]


def hoisted_lanes(compiled, params, keys, drivers, n: int) -> dict:
    """Noise/driver/automation lanes ``{key: [V, n]}``, computed outside
    the kernel (``jax.random`` stays in XLA)."""
    xs = jax.vmap(lambda p, k: compiled._make_xs(p, k, n, drivers={}))(
        params, keys)
    for mid, arr in (drivers or {}).items():
        xs[mid] = jnp.asarray(arr, dtype=CV_DTYPE)
    return xs


def make_fused_render(compiled, n: int, *, unroll: int = None,
                      interpret: bool = False):
    """The batched render ``(params, state, keys, drivers) -> (audio[V, C,
    n], {}, final_state)`` in the shell (same contract as
    ``make_render_fn(n, batched=True)``)."""
    out_keys = channel_keys(compiled)
    unroll = unroll or default_unroll(compiled)

    def step(params, state, x_t):
        new_states, fb_out, channels, _ = compiled._sample_step(
            params, state["states"], state["fb"], x_t, nograd=True)
        return ({"states": new_states, "fb": fb_out},
                dict(zip(out_keys, channels)))

    def run(params, state, keys, drivers):
        xs = hoisted_lanes(compiled, params, keys, drivers, n)
        outs, final = shell.run(step, n, compiled.derived_params(params),
                                state, xs, out_keys, unroll=unroll,
                                interpret=interpret)
        return jnp.stack([outs[k] for k in out_keys], axis=1), {}, final

    return run


def make_fused_render_buffer(compiled, n: int, *, unroll: int = None,
                             interpret: bool = False):
    """Buffer-feedback compat mode in the shell.

    The reference's previous-*buffer* feedback timing (synth.rs:168-192)
    delays each feedback read by ``block_size`` samples -- too much history
    for registers.  Instead the shell runs one block per call with the
    previous block's fb wires streamed in like hoisted lanes and this
    block's fb values streamed out; an outer ``lax.scan`` chains blocks.
    """
    cfg = compiled.cfg
    block = cfg.block_size
    if n % block != 0:
        raise ValueError(
            f"buffer_feedback mode renders whole blocks: n={n} is not a "
            f"multiple of block_size={block}")
    n_blocks = n // block
    chan_keys = channel_keys(compiled)
    fb_keys = sorted(compiled.fb_keys)
    fb_names = {k: f"fb:{k[0]}#{k[1]}" for k in fb_keys}
    unroll = unroll or default_unroll(compiled)

    def step(params, states, x_t):
        fb_t = {k: x_t[fb_names[k]] for k in fb_keys}
        new_states, fb_out, channels, _ = compiled._sample_step(
            params, states, fb_t, x_t, nograd=True)
        outs = dict(zip(chan_keys, channels))
        outs.update({fb_names[k]: fb_out[k] for k in fb_keys})
        return new_states, outs

    def run(params, state, keys, drivers):
        xs = hoisted_lanes(compiled, params, keys, drivers, n)
        params = compiled.derived_params(params)

        def blocked(a):  # [V, n] -> [n_blocks, V, block]
            return jnp.moveaxis(a.reshape(a.shape[0], n_blocks, block), 1, 0)

        def outer(carry, xs_b):
            states, fb = carry
            lanes = dict(xs_b)
            lanes.update({fb_names[k]: fb[k] for k in fb_keys})
            outs, states = shell.run(
                step, block, params, states, lanes,
                chan_keys + [fb_names[k] for k in fb_keys], unroll=unroll,
                interpret=interpret)
            audio_b = jnp.stack([outs[k] for k in chan_keys], axis=1)
            return (states, {k: outs[fb_names[k]] for k in fb_keys}), audio_b

        (states_f, fb_f), ys = jax.lax.scan(
            outer, (state["states"], state["fb"]),
            {k: blocked(a) for k, a in xs.items()}, length=n_blocks)
        # ys: [n_blocks, V, C, block] -> [V, C, n]
        audio = jnp.moveaxis(ys, 0, 2).reshape(ys.shape[1], ys.shape[2], n)
        return audio, {}, {"states": states_f, "fb": fb_f}

    return run
