"""Kernel-speed gradients: the voice-kernel shell forward AND backward.

``jax.grad`` through the scan engine works but runs one XLA loop iteration
per sample, forward and backward.  For register-friendly patches
(ops/fused.REGISTER_TYPES) this wraps the whole-patch step in
:func:`ops.shell.differentiable`: the forward is the shell kernel, also
checkpointing the module state every ``shell.CHUNK`` samples; the backward
is the shell's reverse-sweep kernel (recompute each chunk from its
checkpoint, then run the per-sample VJP backwards through it).

Scope: fused-eligible patches, batched, fast precision.  Driver and noise
lanes get zero cotangents.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import fused, shell


def make_fused_vjp(compiled, n: int, *, unroll: int = 4,
                   interpret: bool = False):
    """A differentiable batched render ``fn(params, state, keys, drivers)
    -> (audio[V, C, n], {}, final_state)`` with gradients flowing to float
    params and float initial-state leaves."""
    out_keys = fused.channel_keys(compiled)

    def step(params, state, x_t):
        new_states, fb_out, channels, _ = compiled._sample_step(
            params, state["states"], state["fb"], x_t)
        return ({"states": new_states, "fb": fb_out},
                dict(zip(out_keys, channels)))

    core = shell.differentiable(step, n, out_keys, unroll=unroll,
                                interpret=interpret)

    def render(params, state, keys, drivers):
        xs = jax.lax.stop_gradient(
            fused.hoisted_lanes(compiled, params, keys, drivers, n))
        # derived params are computed OUTSIDE the custom_vjp, so autodiff
        # chains their cotangents back to the raw params
        outs, final = core(compiled.derived_params(params), state, xs)
        return jnp.stack([outs[k] for k in out_keys], axis=1), {}, final

    return render
