"""Freeverb's chunk-parallel block path vs a literal per-sample reference.

``modules/freeverb._block`` (plain XLA: ring rotation, a log-doubling solve
of each comb's damping one-pole per chunk, allpass sub-pieces) must
reproduce the exact comb/allpass tick semantics of the freeverb crate (see
modules/freeverb.py), including carried damping state, line roll-over
across chunks and calls, and the series allpass sub-piece order.  The
reference is float32 NumPy over chronological lines (hist[0] = next read).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from srack_tpu.config import AudioConfig
from srack_tpu.modules.freeverb import (FREEVERB, _step, freeverb_gains,
                                        line_lengths)

# 4.8 kHz keeps the lines short (combs 121..161, allpasses 24..60 samples)
# so a few hundred samples cross several chunks and a ragged tail
CFG = AudioConfig(sample_rate=4800, block_size=64, channels=2,
                  precision="fast")
CL, CR, AL, AR = line_lengths(CFG.sample_rate)
COMB_LENS = CL + CR
AP_LENS = AL + AR
COMB_KEYS = [f"cl{i}" for i in range(8)] + [f"cr{i}" for i in range(8)]
AP_KEYS = [f"al{i}" for i in range(4)] + [f"ar{i}" for i in range(4)]


def _reference(mixed, fs0, damp, feed, hists):
    """Per-sample Freeverb core in float32 NumPy (8 combs + 4 allpasses per
    channel; chronological shift-register lines, hist[0] = next read)."""
    n = mixed.shape[0]
    h = [np.array(x, np.float32) for x in hists]
    fs = np.array(fs0, np.float32)
    out_l = np.zeros(n, np.float32)
    out_r = np.zeros(n, np.float32)
    for t in range(n):
        outs = [np.float32(0.0), np.float32(0.0)]
        for j in range(16):
            y = h[j][0]
            fs[j] = np.float32(y * np.float32(1.0 - damp)
                               + fs[j] * np.float32(damp))
            w = np.float32(mixed[t] + fs[j] * np.float32(feed))
            h[j] = np.append(h[j][1:], w).astype(np.float32)
            outs[j // 8] = np.float32(outs[j // 8] + y)
        for ch in range(2):
            x = outs[ch]
            for a in range(4):
                hj = 16 + ch * 4 + a
                delayed = h[hj][0]
                w = np.float32(x + delayed * np.float32(0.5))
                x = np.float32(delayed - x)
                h[hj] = np.append(h[hj][1:], w).astype(np.float32)
            outs[ch] = x
        out_l[t], out_r[t] = outs
    return out_l, out_r, fs, h


def _setup(seed, dampening=0.875):
    """Random lines/damping state; wet=1, width=1, dry=0 so the block
    output is exactly 3x (SCALE_WET) the raw left/right reverb."""
    rng = np.random.default_rng(seed)
    statics, params = FREEVERB.make(CFG, dampening=dampening, wet=1.0,
                                    width=1.0, room_size=0.5, dry=0.0)
    params = jax.tree.map(jnp.asarray, params)
    hists = [rng.normal(size=l).astype(np.float32) * 0.1
             for l in COMB_LENS + AP_LENS]
    fs0 = rng.normal(size=16).astype(np.float32) * 0.1
    state = dict(FREEVERB.init_state(CFG, statics))
    for k, h in zip(COMB_KEYS + AP_KEYS, hists):
        state[k] = jnp.asarray(h)
    for j, k in enumerate(COMB_KEYS):
        state[f"c{k[1]}{k[2:]}_fs"] = jnp.float32(fs0[j])
    damp, feed, in_gain, *_ = freeverb_gains(params, jnp.float32)
    return (rng, statics, params, state, hists, fs0, np.float32(damp),
            np.float32(feed), np.float32(in_gain))


def _block(statics, params, state, x):
    x = jnp.asarray(x)
    return FREEVERB.block(CFG, statics, params, state, (x, x), None,
                          x.shape[0])


def _check(new_state, outs, want):
    want_l, want_r, want_fs, want_h = want
    np.testing.assert_allclose(np.asarray(outs[0]) / 3.0, want_l,
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(outs[1]) / 3.0, want_r,
                               atol=2e-5, rtol=2e-5)
    for j, k in enumerate(COMB_KEYS):
        np.testing.assert_allclose(
            np.asarray(new_state[f"c{k[1]}{k[2:]}_fs"]), want_fs[j],
            atol=2e-5, rtol=2e-5)
    for k, w in zip(COMB_KEYS + AP_KEYS, want_h):
        np.testing.assert_allclose(np.asarray(new_state[k]), w,
                                   atol=2e-5, rtol=2e-5)
        assert int(new_state[f"{k}_idx"]) == 0


def _mixed(x, in_gain):
    return ((x + x) * in_gain).astype(np.float32)


def test_kernel_matches_per_sample_reference():
    rng, statics, params, state, hists, fs0, damp, feed, g = _setup(0)
    n = 300  # two full 121-sample chunks and a ragged tail
    x = rng.normal(size=n).astype(np.float32)
    new_state, outs = _block(statics, params, state, x)
    _check(new_state, outs, _reference(_mixed(x, g), fs0, damp, feed,
                                       hists))


def test_multi_grid_step_kc_state_carry():
    """Two consecutive block calls carry the lines and damping state: the
    second call starts from the first call's rotated lines and matches the
    reference run straight through."""
    rng, statics, params, state, hists, fs0, damp, feed, g = _setup(6)
    x = rng.normal(size=400).astype(np.float32)
    mid_state, outs_a = _block(statics, params, state, x[:170])
    end_state, outs_b = _block(statics, params, mid_state, x[170:])
    outs = [jnp.concatenate([a, b]) for a, b in zip(outs_a, outs_b)]
    _check(end_state, outs, _reference(_mixed(x, g), fs0, damp, feed,
                                       hists))


@pytest.mark.parametrize("damp_v", [0.15, 0.35, 0.6])
def test_damping_tiers(damp_v):
    """Light, medium and heavy damping against the per-sample reference
    (the log-doubling solve reassociates the one-pole: float-rounding
    scale differences only)."""
    rng, statics, params, state, hists, fs0, damp, feed, g = _setup(
        3, dampening=damp_v / 0.4)
    x = rng.normal(size=256).astype(np.float32)
    new_state, outs = _block(statics, params, state, x)
    _check(new_state, outs, _reference(_mixed(x, g), fs0, damp, feed,
                                       hists))


def test_kernel_batched_rows():
    """Voices under the engine's vmap, each with its own input."""
    rng, statics, params, state, hists, fs0, damp, feed, g = _setup(1)
    v, n = 3, 200
    x = rng.normal(size=(v, n)).astype(np.float32)
    states, outs = jax.vmap(lambda a: _block(statics, params, state, a))(
        jnp.asarray(x))
    for i in range(v):
        want = _reference(_mixed(x[i], g), fs0, damp, feed, hists)
        np.testing.assert_allclose(np.asarray(outs[0][i]) / 3.0, want[0],
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(np.asarray(outs[1][i]) / 3.0, want[1],
                                   atol=2e-5, rtol=2e-5)


def test_entry_mix_matches_shell():
    """The full module -- stereo inputs, width, dry, rings starting at a
    non-zero write index -- against its own per-sample step folded by
    ``lax.scan`` (the scan engine's semantics)."""
    rng = np.random.default_rng(4)
    statics, params = FREEVERB.make(CFG, dampening=0.6, wet=0.4, width=0.3,
                                    room_size=0.8, dry=0.25)
    params = jax.tree.map(jnp.asarray, params)
    state = dict(FREEVERB.init_state(CFG, statics))
    for k in COMB_KEYS + AP_KEYS:
        state[k] = jnp.asarray(rng.normal(size=state[k].shape[0])
                               .astype(np.float32) * 0.1)
        state[f"{k}_idx"] = jnp.int32(rng.integers(0, state[k].shape[0]))
    n = 333
    xl = jnp.asarray(rng.normal(size=n).astype(np.float32))
    xr = jnp.asarray(rng.normal(size=n).astype(np.float32))
    _, (bl, br) = FREEVERB.block(CFG, statics, params, state, (xl, xr),
                                 None, n)

    def body(st, x):
        st, outs = _step(CFG, statics, params, st, x)
        return st, outs

    _, (sl, sr) = jax.lax.scan(body, state, (xl, xr))
    np.testing.assert_allclose(np.asarray(bl), np.asarray(sl), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(br), np.asarray(sr), atol=2e-5,
                               rtol=2e-5)
