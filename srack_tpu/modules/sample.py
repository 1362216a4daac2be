"""WAV sample player.

Reference: src/synth/sample.rs:192-240.  A rising gate edge restarts
playback; playback rate is ``(wav_sr / engine_sr) * 2^cv`` (pitch CV!,
sample.rs:233-234); resampling is nearest-neighbour by truncating the f32
position (sample.rs:228); when the position runs past the end, playback
stops and the position resets (sample.rs:223-226).  The decoder takes
channel 0 only (sample.rs:42,59) -- see srack_tpu.io.wav.

The decoded waveform is a *traced parameter* (padded to a static
``max_len``), so swapping samples of the same length doesn't recompile, the
per-sample read is a gather, and renders are differentiable w.r.t. the
waveform itself.  The reference's audio-thread ``try_lock`` skip path
(sample.rs:202-208) has no analogue -- there is no audio thread to starve.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import AudioConfig
from ..ops.basic import (block_lane, block_transitions, fast_cumsum,
                         monotone_fill, t_index, transition, transition_init)
from .base import CV_DTYPE, ModuleDef, const_ports, cv, in_or


def _make(cfg: AudioConfig, samples=None, wav_sample_rate: float | None = None,
          max_len: int | None = None):
    if samples is None:
        data = np.zeros((0,), dtype=np.float32)
    else:
        data = np.asarray(samples, dtype=np.float32).reshape(-1)
    n = int(data.shape[0])
    if max_len is None:
        max_len = max(n, 1)
    if n > max_len:
        raise ValueError(f"sample of {n} frames exceeds max_len={max_len}")
    padded = np.zeros((max_len,), dtype=np.float32)
    padded[:n] = data
    params = {
        "samples": jnp.asarray(padded),
        "length": jnp.asarray(n, dtype=jnp.int32),
        "wav_sr": jnp.asarray(
            float(wav_sample_rate) if wav_sample_rate else 0.0, dtype=CV_DTYPE),
    }
    return ("sample", max_len), params


def _init_state(cfg: AudioConfig, statics):
    return {
        "pos": jnp.asarray(0.0, dtype=CV_DTYPE),
        "playing": jnp.asarray(False),
        "gate_last": transition_init(),
    }


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    (_, max_len) = statics
    gate = in_or(ins[0], 0.0)
    cv_in = in_or(ins[1], 0.0)
    gate_last, trigger = transition(state["gate_last"], gate)

    pos = jnp.where(trigger, 0.0, state["pos"])
    playing = jnp.logical_or(trigger, state["playing"])

    pos_i = pos.astype(jnp.int32)  # truncation; pos is non-negative
    wrapped = pos_i >= params["length"]
    pos = jnp.where(wrapped, 0.0, pos)
    playing = jnp.where(wrapped, False, playing)
    pos_i = jnp.where(wrapped, 0, pos_i)

    read = params["samples"][jnp.clip(pos_i, 0, max_len - 1)]
    out = jnp.where(params["length"] > 0, read, 0.0).astype(CV_DTYPE)

    rate = params["wav_sr"] / cfg.sample_rate * jnp.exp2(cv_in)
    pos = jnp.where(playing, pos + rate, pos)

    new_state = {"pos": pos.astype(CV_DTYPE), "playing": playing,
                 "gate_last": gate_last}
    return new_state, (out,)


def _block(cfg: AudioConfig, statics, params, state, ins, xs, n):
    """Whole-block sample playback.

    Playback is *segmented* by gate triggers: within a segment the position
    is a prefix sum of rates from the trigger (exclusive -- the reference
    reads before advancing, sample.rs:228-234), the end-of-sample stop is a
    monotone threshold crossing (after which output holds ``samples[0]``,
    exactly the serial semantics of reset-then-read), and the carried
    pre-trigger region continues from the carried position/playing flag.
    The only per-sample cost left is the waveform gather.
    """
    (_, max_len) = statics
    lane = state["pos"].shape
    gate = block_lane(ins[0], lane, n)
    # unconnected CV input = constant per-voice rate: the position prefix
    # sum collapses to ``base * arange(n)`` (no scan)
    cv_const = ins[1] is None
    cv_in = None if cv_const else block_lane(ins[1], lane, n)

    gate_last, trig = block_transitions(state["gate_last"], gate)

    length_f = params["length"].astype(CV_DTYPE)
    base = (params["wav_sr"] / cfg.sample_rate).astype(CV_DTYPE)
    if cv_const:
        rate_last = base
        cum_excl = base * t_index(n, lane, dtype=CV_DTYPE)
    else:
        rate = base * jnp.exp2(cv_in)
        rate_last = rate[-1]
        cum_excl = fast_cumsum(rate, axis=0) - rate

    # last-trigger fill of cum_excl = running MAX of cum_excl at triggers
    # (rates are non-negative so cum_excl is non-decreasing; max is exact
    # and order-free)
    filled, has_trig = monotone_fill(cum_excl, trig, axis=0)
    carry_pos = jnp.where(state["playing"], cum_excl + state["pos"],
                          state["pos"])
    s = jnp.where(has_trig, cum_excl - filled, carry_pos)
    crossed = s >= length_f  # monotone within a segment (rate > 0)

    idx = jnp.clip(s.astype(jnp.int32), 0, max_len - 1)
    read = params["samples"][idx]
    first = params["samples"][0]
    out = jnp.where(params["length"] > 0,
                    jnp.where(crossed, first, read), 0.0).astype(CV_DTYPE)

    active_last = jnp.where(has_trig[-1], True, state["playing"])
    playing_end = jnp.logical_and(active_last,
                                  jnp.logical_not(crossed[-1]))
    pos_end = jnp.where(playing_end, s[-1] + rate_last,
                        jnp.where(crossed[-1], 0.0, state["pos"]))
    new_state = {"pos": pos_end.astype(CV_DTYPE), "playing": playing_end,
                 "gate_last": gate_last}
    return new_state, (out,)


_nin, _inlabels = const_ports(2, ("Gate", "CV"))
_nout, _outlabels = const_ports(1, (None,))

SAMPLE = ModuleDef(
    type_name="Sample",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    block=_block,
)
