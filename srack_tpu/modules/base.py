"""Module contract for the synthesis engine.

The reference models a module as a trait object with mutable per-output
buffers and a ``calc()`` that runs a per-sample loop over one block
(reference: src/synth.rs:222-263).  None of that survives contact with XLA;
here a module *type* is pure data plus pure functions:

* ``make``        -- construction: kwargs -> (statics, params)
* ``init_state``  -- the per-voice state pytree (the ``lax.scan`` carry slice)
* ``step``        -- per-sample transition:
                     (params, state, ins) -> (state, outs)

``statics`` are hashable construction-time attributes that shape the traced
program (e.g. the Math op, mixer input count); changing them recompiles.
``params`` are traced arrays (the "sliders"); changing them never recompiles,
mirroring how the reference's UI sliders mutate fields between ticks without
re-planning.  ``state`` is everything the reference keeps in ``&mut self``
between samples (phase accumulators, filter poles, envelope mode, edge
detectors), i.e. exactly the scan carry.

Signals are untyped f32 control voltages, interchangeable between audio /
pitch / gate / clock uses (reference: src/synth.rs:220) -- the modular-synth
property the engine preserves.  Unconnected inputs arrive as Python ``None``
(connectivity is static per compiled patch, as it is between re-plans in the
reference), and each ``step`` reproduces the reference's ``Option<&[f32]>``
fallback behaviour explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import jax.numpy as jnp

from ..config import AudioConfig

CV_DTYPE = jnp.float32

# Type aliases for readability; everything is pytrees of jnp arrays.
Params = dict
State = dict
Statics = Any  # hashable
Ins = Sequence[Optional[jnp.ndarray]]
Outs = tuple


@dataclasses.dataclass(frozen=True)
class ModuleDef:
    """A module type: pure construction + state-transition functions."""

    type_name: str
    # (cfg, **kwargs) -> (statics, params)
    make: Callable[..., tuple]
    # (cfg, statics) -> int
    num_inputs: Callable[[AudioConfig, Statics], int]
    num_outputs: Callable[[AudioConfig, Statics], int]
    # (cfg, statics) -> tuple of Optional[str]
    input_labels: Callable[[AudioConfig, Statics], tuple]
    output_labels: Callable[[AudioConfig, Statics], tuple]
    # (cfg, statics) -> State
    init_state: Callable[[AudioConfig, Statics], State]
    # (cfg, statics, params, state, ins, x) -> (state, outs)
    step: Callable[..., tuple]
    # Optional pre-generated per-sample auxiliary input (e.g. noise):
    # (cfg, statics, params, key, n) -> pytree with leading axis n
    make_xs: Optional[Callable[..., Any]] = None
    # Optional whole-block implementation used by the block-mode engine:
    # (cfg, statics, params, state, ins_blocks, xs) -> (state, out_blocks)
    block: Optional[Callable[..., tuple]] = None
    # Optional per-render derived params, computed ONCE outside the
    # per-sample loop and merged into params before any step/block runs:
    # (cfg, statics, params, connected: tuple[bool]) -> dict.
    # Anything a step recomputes per sample from params alone belongs here:
    # the per-sample loop then carries the result instead of recomputing
    # it, whatever the kernel compiler would or would not hoist.
    derive: Optional[Callable[..., dict]] = None
    # Optional step variant for engines that are never differentiated
    # (the plain fused render, the block engine): must produce bit-identical
    # primal outputs and state to ``step`` but may elide gradient-only
    # machinery (e.g. the oscillator's straight-through shadow-phase ops,
    # which are exactly zero in the primal yet cost real issue slots: a
    # compiler cannot fold float ``x - stop_grad(x)`` to 0).
    # Differentiable paths (scan autodiff, ops/fused_vjp.py) always use
    # ``step``.
    step_nograd: Optional[Callable[..., tuple]] = None
    # Param names whose per-sample automation the *block engine* can run
    # without forcing the module into the serial stage: either the module
    # is stateless (step broadcasts [n]-shaped params elementwise) or its
    # ``block`` impl explicitly handles per-sample param lanes.  Automated
    # params NOT listed here push the module into the serial stage (exact
    # per-sample semantics at serial-stage speed).
    auto_block_params: frozenset = frozenset()
    # Custom-module opt-in for the voice-kernel shell (ops/shell.py: the
    # fused whole-patch render and the block engine's serial stage).
    # Built-in types are whitelisted explicitly; a registered custom type
    # is only traced into the shell when it declares ``register_safe=True``,
    # which promises: ``step``/``step_nograd`` use only elementwise jnp
    # math (no gather/scatter, no slicing or stacking of arrays -- the
    # shell's Triton route lowers neither), and state/params are per-voice
    # scalars or small fixed-size vectors that the step indexes element by
    # element (the shell hands them over as lists of per-voice rows, like
    # the Moog filter's [5] stage vector).  Without the flag the module
    # still runs on every engine: scan always, block via its lax.scan
    # serial stage (block_engine.PALLAS_SAFE fallback).
    register_safe: bool = False

    def port_index(self, cfg: AudioConfig, statics: Statics, port, *, output: bool) -> int:
        """Resolve a port given by index or label to an index."""
        labels = (self.output_labels if output else self.input_labels)(cfg, statics)
        n = (self.num_outputs if output else self.num_inputs)(cfg, statics)
        if isinstance(port, str):
            matches = [i for i, l in enumerate(labels) if l == port]
            if not matches:
                raise KeyError(
                    f"{self.type_name} has no {'output' if output else 'input'} "
                    f"named {port!r}; labels are {labels}"
                )
            return matches[0]
        idx = int(port)
        if not 0 <= idx < n:
            raise IndexError(
                f"{self.type_name} {'output' if output else 'input'} index {idx} "
                f"out of range (0..{n - 1})"
            )
        return idx


def const_ports(n: int, labels: tuple) -> tuple:
    """Helpers for modules whose port count doesn't depend on cfg/statics."""
    assert len(labels) == n
    return (lambda cfg, s: n), (lambda cfg, s: labels)


def cv(value) -> jnp.ndarray:
    return jnp.asarray(value, dtype=CV_DTYPE)


def in_or(x: Optional[jnp.ndarray], fallback) -> jnp.ndarray:
    """Reference's unconnected-input fallback (``match buf { None => ... }``)."""
    if x is None:
        return cv(fallback)
    return x
