"""Oscillator and Noise modules.

Semantics mirror the reference oscillator (src/synth/oscillator.rs:9-306):
pitch convention 1.0 CV = 1 octave with 0.0 -> 440 Hz
(oscillator.rs:43-48), sine/square/saw outputs with polyBLEP band-limiting
(oscillator.rs:124-153), and a Sync input that resets phase on a rising edge.

Accelerator-first design notes
------------------------------
* ``exact`` precision keeps the phase accumulator in f64 like the reference
  (oscillator.rs:21 ``pos: f64``); requires ``jax_enable_x64`` and is meant
  for CPU oracle validation.
* ``fast`` precision keeps phase in **uint32 fixed point** (1 ulp = 2^-32 of
  a cycle).  Integer adds wrap naturally, so ``pos % 1.0`` is free and the
  accumulator has *zero* drift over arbitrarily long renders -- strictly
  better behaved than a raw f32 accumulator, at f32 cost.
* Noise is reproducible counter-based randomness (threefry) hoisted out of
  the scan as per-sample xs; the reference uses non-reproducible
  ``rand::random`` (oscillator.rs:381-388) so noise paths are excluded from
  sample-exact comparisons (SURVEY.md §7 hard part f).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import AudioConfig
from ..ops.basic import (block_transitions, delta_to_fixed, fast_cumsum,
                         fast_exp2, fast_sinpi, forward_fill,
                         phase_fixed_init, poly_blep, poly_blep_signed,
                         signed_turns, t_index, transition, transition_init)
from .base import CV_DTYPE, ModuleDef, const_ports, cv, in_or


def _osc_make(cfg: AudioConfig, val: float = 0.0, antialiasing: bool = True):
    statics = ("antialias", bool(antialiasing))
    params = {"val": cv(val)}
    return statics, params


def _osc_init_state(cfg: AudioConfig, statics):
    if cfg.exact:
        pos = jnp.asarray(0.0, dtype=jnp.float64)
        return {"pos": pos, "sync_last": transition_init()}
    # pos_g: gradient-shadow float phase for fast mode.  The int32 phase is
    # exact but non-differentiable (its tangent type is float0); pos_g is an
    # unwrapped float accumulator whose *primal contribution to outputs
    # cancels exactly* (straight-through: pos_f + (pos_g - stop_grad(pos_g)))
    # while its tangent carries d(phase)/d(delta) -- making fast-mode pitch
    # learnable through the Pallas VJP (ROADMAP item: STE pitch gradients).
    return {"pos": phase_fixed_init(),
            "pos_g": jnp.asarray(0.0, dtype=CV_DTYPE),
            "sync_last": transition_init()}


def _osc_derive(cfg: AudioConfig, statics, params, connected):
    """With the CV input unconnected (LFOs, clocks, fixed-pitch voices) the
    whole frequency chain ``440 * 2^val / sr`` is loop-invariant; hoisting
    it removes ~10 ops from the per-sample step (see ModuleDef.derive)."""
    if connected and connected[0]:
        return {}
    if cfg.exact:
        val = params["val"].astype(jnp.float64)
        return {"delta": 440.0 * jnp.exp2(val) / cfg.sample_rate}
    delta = (fast_exp2(params["val"])
             * (440.0 / cfg.sample_rate)).astype(CV_DTYPE)
    return {"delta": delta, "dfix": delta_to_fixed(delta)}


def _osc_step(cfg: AudioConfig, statics, params, state, ins, x=None,
              with_ste: bool = True):
    (_, antialias) = statics
    cv_in, sync_in = ins
    if sync_in is None:
        # Sync unconnected is static knowledge: skip the edge detector
        # entirely (the select chain costs real issue slots in the fused
        # kernel; the detector state stays False, matching transition() on
        # a constant-0 input)
        sync_last, fired = jnp.zeros((), jnp.bool_), None
    else:
        sync_last, fired = transition(state["sync_last"], in_or(sync_in, 0.0))

    def reset(z, v):
        return v if fired is None else jnp.where(fired, z, v)

    if cfg.exact:
        pos = reset(0.0, state["pos"])
        if cv_in is None and "delta" in params:
            delta = params["delta"]  # hoisted by _osc_derive
        else:
            val = params["val"].astype(jnp.float64)
            octs = val if cv_in is None else cv_in.astype(jnp.float64) + val
            delta = 440.0 * jnp.exp2(octs) / cfg.sample_rate  # f64
        pos_f = pos
        new_pos = jnp.mod(pos + delta, 1.0)
        ste = None
    else:
        pos_i = reset(jnp.int32(0), state["pos"])
        if cv_in is None and "dfix" in params:
            delta, dfix = params["delta"], params["dfix"]  # hoisted
        else:
            octs = params["val"] if cv_in is None else cv_in + params["val"]
            # one pre-folded constant multiply (440/sr), not mul+div: the
            # CV-modulated pitch chain runs per sample in the fused kernel
            delta = (fast_exp2(octs)
                     * (440.0 / cfg.sample_rate)).astype(CV_DTYPE)
            dfix = delta_to_fixed(delta)
        acc = reset(0.0, state["pos_g"])
        if with_ste:
            # straight-through phase tangent: ste == 0 exactly in the
            # primal (x - stop_grad(x)), but d(ste)/d(delta-history) == 1
            ste = acc - jax.lax.stop_gradient(acc)
        else:
            # non-differentiated engines skip the shadow ops (ste is
            # exactly 0 in the primal, so outputs are bit-identical); the
            # pos_g carry still advances so state hand-off to a training
            # run stays correct
            ste = None
        new_pos = pos_i + dfix  # wraps exactly mod 2^32
        new_acc = acc + delta

    if cfg.exact:
        sine = jnp.sin(pos_f * (2.0 * jnp.pi)).astype(CV_DTYPE)
        naive_square = jnp.where(pos_f < 0.5, -1.0, 1.0).astype(CV_DTYPE)
        naive_saw = pos_f.astype(CV_DTYPE) * 2.0 - 1.0
        if antialias:
            blep0 = poly_blep(pos_f, delta)
            blep_half = poly_blep(jnp.mod(pos_f + 0.5, 1.0), delta)
            square = naive_square - (blep0 - blep_half).astype(CV_DTYPE)
            saw = naive_saw - blep0.astype(CV_DTYPE)
        else:
            square = naive_square
            saw = naive_saw
    else:
        sine, square, saw = _fast_waves(pos_i, delta, ste, antialias)

    new_state = {"pos": new_pos, "sync_last": sync_last}
    if not cfg.exact:
        new_state["pos_g"] = new_acc
    return new_state, (sine, square, saw)


def _fast_waves(pos_i, delta, ste, antialias: bool):
    """Fast-mode waveforms entirely in the *signed-turns* domain.

    The unsigned phase in [0,1) is never reconstructed (saves the
    convert + wrap-fix chain): with s = signed_turns(pos) in [-1, 1),

    * sine   = sinpi(s)                    (1-periodic, sign-free)
    * square = -1 where pos >= 0 else +1   (pos >= 0  <=>  phase < 0.5)
    * saw    = s + square                  (s - 1 on [0,.5), s + 1 on [.5,1))
    * both polyBLEP corrections are sign(-u)(1-|u|)^2 in units of dt
      (ops/basic.poly_blep_signed); the half-phase discontinuity's signed
      distance is exactly ``naive_saw``, so the square's second blep reuses
      it for free.

    ``ste`` (or None) is the straight-through gradient shadow; signed turns
    move at 2x phase, hence the 2x tangent contribution.
    """
    s = signed_turns(pos_i)
    if ste is not None:
        s = s + 2.0 * ste
    sine = fast_sinpi(s).astype(CV_DTYPE)
    naive_square = jnp.where(pos_i >= 0, -1.0, 1.0).astype(CV_DTYPE)
    naive_saw = s.astype(CV_DTYPE) + naive_square
    if antialias:
        inv2dt = 0.5 / delta
        blep0 = poly_blep_signed(s * inv2dt)
        blep_half = poly_blep_signed(naive_saw * inv2dt)
        square = naive_square - (blep0 - blep_half).astype(CV_DTYPE)
        saw = naive_saw - blep0.astype(CV_DTYPE)
    else:
        square = naive_square
        saw = naive_saw
    return sine, square, saw


def _osc_step_nograd(cfg: AudioConfig, statics, params, state, ins, x=None):
    return _osc_step(cfg, statics, params, state, ins, x, with_ste=False)


def _osc_block(cfg: AudioConfig, statics, params, state, ins, xs, n):
    """Whole-block oscillator: phase by (segmented) prefix sum.

    The per-sample recurrence ``pos += delta; pos %= 1`` is a prefix sum; a
    Sync reset makes it a *segmented* prefix sum (phase restarts at the
    last rising edge).  In fast mode the int32 fixed-point representation
    makes the cumsum exact (wrap = two's-complement overflow), so block and
    per-sample execution agree bit-for-bit; in exact (f64) mode the
    reassociated summation differs from the serial engine by rounding only.
    """
    (_, antialias) = statics
    cv_in, sync_in = ins
    lane = state["pos"].shape  # () on the host path, (8, 128) in-kernel
    full = (n,) + lane
    tidx = t_index(n, lane)
    # automated ``val`` arrives as a per-sample [n] lane (block-engine
    # automation): the rate varies, so the constant-rate closed form below
    # is wrong -- take the prefix-sum path instead
    val_varies = jnp.ndim(params["val"]) > len(lane)
    const_rate = cv_in is None and not val_varies

    if cfg.exact:
        if cv_in is None and not val_varies and "delta" in params:
            delta = params["delta"]
        else:
            val = params["val"].astype(jnp.float64)
            octs = val if cv_in is None else cv_in.astype(jnp.float64) + val
            delta = 440.0 * jnp.exp2(octs) / cfg.sample_rate
        if const_rate:
            # constant rate (LFOs, clocks): closed form, no prefix sum
            excl = delta * tidx
            incl = delta * (tidx + 1.0)
        else:
            delta = jnp.broadcast_to(delta, full)
            incl = fast_cumsum(delta, axis=0)
            excl = incl - delta
        delta = jnp.broadcast_to(delta, full)
        if sync_in is None:
            sync_last = state["sync_last"]
            pos_acc = state["pos"] + excl
            next_pos = state["pos"] + incl[-1]
        else:
            sync_last, fires = block_transitions(state["sync_last"], sync_in)
            excl_at_fire, fired_yet = forward_fill(
                jnp.broadcast_to(excl, full), fires, axis=0)
            pos_acc = jnp.where(fired_yet, excl - excl_at_fire,
                                state["pos"] + excl)
            next_pos = pos_acc[-1] + delta[-1]
        pos_f = jnp.mod(pos_acc, 1.0)
        next_pos = jnp.mod(next_pos, 1.0)
    else:
        if cv_in is None and not val_varies and "dfix" in params:
            delta_f, dfix = params["delta"], params["dfix"]
        else:
            octs = params["val"] if cv_in is None else cv_in + params["val"]
            delta_f = (fast_exp2(octs)
                       * (440.0 / cfg.sample_rate)).astype(CV_DTYPE)
            dfix = delta_to_fixed(delta_f)
        if const_rate:
            excl = dfix * tidx  # int32 multiply wraps exactly mod 2^32
            incl = excl + dfix
        else:
            dfix = jnp.broadcast_to(dfix, full)
            incl = fast_cumsum(dfix, axis=0)  # int32 adds wrap mod 2^32
            excl = incl - dfix
        delta_f = jnp.broadcast_to(delta_f, full)
        dfix = jnp.broadcast_to(dfix, full)
        if sync_in is None:
            sync_last = state["sync_last"]
            pos_acc = state["pos"] + excl
            next_pos = state["pos"] + incl[-1]
        else:
            sync_last, fires = block_transitions(state["sync_last"], sync_in)
            excl_at_fire, fired_yet = forward_fill(
                jnp.broadcast_to(excl, full), fires, axis=0)
            pos_acc = jnp.where(fired_yet, excl - excl_at_fire,
                                state["pos"] + excl)
            next_pos = pos_acc[-1] + dfix[-1]
        # pos_g carry (gradient-shadow float phase; see _osc_init_state).
        # Block kernels aren't differentiated, so only the end value is
        # needed -- same reset-then-accumulate law as the serial step.
        acc0 = state["pos_g"]
        if sync_in is None:
            acc_end = acc0 + jnp.sum(delta_f, axis=0)
        else:
            cum_f = fast_cumsum(delta_f, axis=0)
            excl_f = cum_f - delta_f
            excl_f_fire, fired_yet_f = forward_fill(excl_f, fires, axis=0)
            acc_end = jnp.where(fired_yet_f[-1],
                                cum_f[-1] - excl_f_fire[-1],
                                acc0 + cum_f[-1])

    if cfg.exact:
        sine = jnp.sin(pos_f * (2.0 * jnp.pi)).astype(CV_DTYPE)
        naive_square = jnp.where(pos_f < 0.5, -1.0, 1.0).astype(CV_DTYPE)
        naive_saw = pos_f.astype(CV_DTYPE) * 2.0 - 1.0
        if antialias:
            blep0 = poly_blep(pos_f, delta)
            blep_half = poly_blep(jnp.mod(pos_f + 0.5, 1.0), delta)
            square = naive_square - (blep0 - blep_half).astype(CV_DTYPE)
            saw = naive_saw - blep0.astype(CV_DTYPE)
        else:
            square, saw = naive_square, naive_saw
    else:
        # identical primitive sequence to the per-sample step's fast path,
        # so block and serial execution stay bit-for-bit equal
        sine, square, saw = _fast_waves(pos_acc, delta_f, None, antialias)

    new_state = {"pos": next_pos, "sync_last": sync_last}
    if not cfg.exact:
        new_state["pos_g"] = acc_end.astype(CV_DTYPE)
    return new_state, (sine, square, saw)


_osc_nin, _osc_inlabels = const_ports(2, ("CV", "Sync"))
_osc_nout, _osc_outlabels = const_ports(3, ("Sine", "Square", "Sawtooth"))

OSCILLATOR = ModuleDef(
    type_name="Oscillator",
    make=_osc_make,
    num_inputs=_osc_nin,
    num_outputs=_osc_nout,
    input_labels=_osc_inlabels,
    output_labels=_osc_outlabels,
    init_state=_osc_init_state,
    step=_osc_step,
    step_nograd=_osc_step_nograd,
    block=_osc_block,
    derive=_osc_derive,
    # per-sample pitch automation: the block impl switches to the
    # prefix-sum phase path when ``val`` arrives as an [n] lane
    auto_block_params=frozenset({"val"}),
)


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------

def _noise_make(cfg: AudioConfig, seed: int = 0):
    return ("noise",), {"seed": jnp.asarray(seed, dtype=jnp.uint32)}


def _noise_init_state(cfg: AudioConfig, statics):
    return {}


def _noise_make_xs(cfg: AudioConfig, statics, params, key, n: int):
    key = jax.random.fold_in(key, params["seed"])
    u = jax.random.uniform(key, (n,), dtype=CV_DTYPE)
    # reference: (rand::random::<f32>() - 0.5) * 2.0  (oscillator.rs:385)
    return (u - 0.5) * 2.0


def _noise_step(cfg: AudioConfig, statics, params, state, ins, x=None):
    return state, (x,)


_noise_nin, _noise_inlabels = const_ports(0, ())
_noise_nout, _noise_outlabels = const_ports(1, (None,))

NOISE = ModuleDef(
    type_name="Noise",
    make=_noise_make,
    num_inputs=_noise_nin,
    num_outputs=_noise_nout,
    input_labels=_noise_inlabels,
    output_labels=_noise_outlabels,
    init_state=_noise_init_state,
    step=_noise_step,
    make_xs=_noise_make_xs,
)
