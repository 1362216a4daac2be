"""Whole-block Sample playback (modules/sample.py ``_block``, plain XLA).

Pins the block path -- segmented position prefix sums, end-of-sample
threshold crossing, the waveform gather -- against a serial NumPy
re-statement of the reference player's per-tick semantics
(src/synth/sample.rs:215-236): rising gate edge restarts playback, rate
``(wav_sr/sr) * 2^cv`` with truncating nearest-neighbour reads,
end-of-sample reset-to-zero stop, carried pos/playing/TransitionDetector
state across blocks.

Rates are chosen exactly representable (multiples of 0.5) so the serial
f32 accumulation and the block path's prefix sums agree bit-for-bit; a
fuzz case with irrational rates allows the rare one-ulp truncation
disagreements nearest-neighbour resampling admits.
"""

import jax
import jax.numpy as jnp
import numpy as np

from srack_tpu.config import AudioConfig
from srack_tpu.modules.sample import SAMPLE

SR = 48000
CFG = AudioConfig(sample_rate=SR, block_size=1024, channels=1,
                  precision="fast")


def serial_ref(gate, cvl, table, length, rate_base,
               pos=0.0, playing=False, last=True):
    """Per-tick semantics of modules/sample._step (the oracle anchor)."""
    n = len(gate)
    out = np.zeros(n, np.float32)
    pos = np.float32(pos)
    for t in range(n):
        above = bool(gate[t] > 0.0)
        trig = above and not last
        last = above
        if trig:
            pos = np.float32(0.0)
            playing = True
        pos_i = int(pos)
        if pos_i >= length:
            pos = np.float32(0.0)
            playing = False
            pos_i = 0
        read = table[min(max(pos_i, 0), len(table) - 1)]
        out[t] = read if length > 0 else 0.0
        rate = np.float32(rate_base * np.exp2(np.float32(cvl[t])))
        if playing:
            pos = np.float32(pos + rate)
    return out, float(pos), bool(playing), bool(last)


def run_kernel(gate, cvl, table, length, rate_base,
               pos=None, playing=None, last=None):
    """The Sample module's block path, vmapped over voices (one table per
    voice).  ``cvl=None`` is the unconnected-CV (constant-rate) path."""
    r, n = gate.shape
    pos = np.zeros(r, np.float32) if pos is None else np.asarray(pos)
    playing = (np.zeros(r, bool) if playing is None
               else np.asarray(playing))
    last = np.ones(r, bool) if last is None else np.asarray(last)
    statics = ("sample", table.shape[1])

    def one(g, c, t, p, pl_, la):
        params = {"samples": t, "length": jnp.asarray(length, jnp.int32),
                  "wav_sr": jnp.float32(rate_base * SR)}
        state = {"pos": p, "playing": pl_, "gate_last": la}
        st, (out,) = SAMPLE.block(CFG, statics, params, state, (g, c),
                                  None, n)
        return out, st["pos"], st["playing"], st["gate_last"]

    outs = jax.jit(jax.vmap(one, in_axes=(0, None if cvl is None else 0,
                                          0, 0, 0, 0)))(
        jnp.asarray(gate, jnp.float32),
        None if cvl is None else jnp.asarray(cvl, jnp.float32),
        jnp.asarray(table, jnp.float32), jnp.asarray(pos, jnp.float32),
        jnp.asarray(playing), jnp.asarray(last))
    return tuple(np.asarray(o) for o in outs)


def check(gate, cvl, table, length, rate_base, **state):
    got, pos_e, play_e, last_e = run_kernel(gate, cvl, table, length,
                                            rate_base, **state)
    r = gate.shape[0]
    for v in range(r):
        st = {k: np.asarray(s)[v] for k, s in state.items()} if state else {}
        cv_v = (np.zeros(gate.shape[1], np.float32) if cvl is None
                else cvl[v])
        want, wpos, wplay, wlast = serial_ref(
            gate[v], cv_v, table[v], length, rate_base, **st)
        np.testing.assert_array_equal(got[v], want, err_msg=f"voice {v}")
        assert pos_e[v] == np.float32(wpos), (v, pos_e[v], wpos)
        assert play_e[v] == wplay
        assert last_e[v] == wlast


K, N, R = 5000, 4608, 4
RNG = np.random.default_rng(0)
TBL = RNG.normal(size=(R, K)).astype(np.float32)
# sparse triggers, ~8 per voice
GATE = (RNG.random((R, N)) > 0.998).astype(np.float32)
ZCV = np.zeros((R, N), np.float32)


def test_triggers_rate_one():
    check(GATE, ZCV, TBL, K, 1.0)


def test_small_table_through_position_kernel():
    """A drums-style small (400-frame) table."""
    k = 400
    tbl = RNG.normal(size=(R, k)).astype(np.float32)
    check(GATE, ZCV, tbl, k, 1.0)
    check(GATE, None, tbl, k, 2.0)


def test_const_rate_path():
    """cv=None (unconnected CV input): the constant-rate path (position =
    base * t, no scan), still bit-exact against the serial reference at
    representable rates."""
    check(GATE, None, TBL, K, 1.0)
    check(GATE, None, TBL, K, 1.5)
    # end-crossing + restarts through the const path
    gate = (RNG.random((R, N)) > 0.999).astype(np.float32)
    check(gate, None, TBL, 600, 2.0)


def test_const_rate_carried_state_and_continuity():
    pos = np.array([10.0, 4000.0, 0.0, 4999.0], np.float32)
    playing = np.array([True, True, False, True])
    check(ZCV, None, TBL, K, 1.5, pos=pos, playing=playing,
          last=np.zeros(R, bool))
    h = N // 2
    full = run_kernel(GATE, None, TBL, K, 1.5)
    a = run_kernel(GATE[:, :h], None, TBL, K, 1.5)
    b = run_kernel(GATE[:, h:], None, TBL, K, 1.5,
                   pos=a[1], playing=a[2], last=a[3])
    np.testing.assert_array_equal(np.concatenate([a[0], b[0]], axis=1),
                                  full[0])
    np.testing.assert_array_equal(b[1], full[1])


def test_exact_fractional_rates():
    # cv=1 -> rate 1.0 from base 0.5; mixed-per-sample cv in {-1,0,1}
    cvl = RNG.integers(-1, 2, (R, N)).astype(np.float32)
    check(GATE, cvl, TBL, K, 0.5)


def test_end_crossing_and_retrigger():
    # short logical length: every burst crosses the end, later triggers
    # restart (reset-to-zero stop, sample.rs:223-226)
    gate = (RNG.random((R, N)) > 0.999).astype(np.float32)
    check(gate, ZCV, TBL, 600, 2.0)


def test_gate_high_at_t0_respects_carried_detector():
    gate = np.ones((R, N // 4), np.float32)
    # last=True (fresh render): no fire -> silence at pos 0 forever
    check(gate, ZCV[:, :N // 4], TBL, K, 1.0,
          last=np.ones(R, bool))
    # last=False (carried low gate): fires at t=0
    check(gate, ZCV[:, :N // 4], TBL, K, 1.0,
          last=np.zeros(R, bool))


def test_carried_playback_state():
    pos = np.array([10.0, 4000.0, 0.0, 4999.0], np.float32)
    playing = np.array([True, True, False, True])
    check(ZCV, ZCV, TBL, K, 1.5, pos=pos, playing=playing,
          last=np.zeros(R, bool))


def test_two_block_continuity_matches_one_block():
    h = N // 2
    full = run_kernel(GATE, ZCV, TBL, K, 1.5)
    a = run_kernel(GATE[:, :h], ZCV[:, :h], TBL, K, 1.5)
    b = run_kernel(GATE[:, h:], ZCV[:, h:], TBL, K, 1.5,
                   pos=a[1], playing=a[2], last=a[3])
    np.testing.assert_array_equal(np.concatenate([a[0], b[0]], axis=1),
                                  full[0])
    np.testing.assert_array_equal(b[1], full[1])
    np.testing.assert_array_equal(b[2], full[2])


def test_zero_length_is_silent():
    got, pos_e, play_e, _ = run_kernel(GATE, ZCV, TBL, 0, 1.0)
    np.testing.assert_array_equal(got, np.zeros_like(got))


def test_fuzz_irrational_rates():
    # non-representable rates: positions may differ by 1 ulp from the
    # serial accumulation; truncation can then pick the neighbouring
    # frame at segment-crossing samples.  Require near-total agreement.
    cvl = (RNG.random((R, N)) * 0.2 - 0.1).astype(np.float32)
    got, *_ = run_kernel(GATE, cvl, TBL, K, 0.937)
    mismatch = 0
    for v in range(R):
        want, *_ = serial_ref(GATE[v], cvl[v], TBL[v], K, 0.937)
        mismatch += int((got[v] != want).sum())
    assert mismatch <= R * N * 1e-3, mismatch


def test_batch_scale_long_table():
    """Real-length (48,000-frame) tables at batch scale -- the workload the
    toy-table drum patch sidesteps."""
    k, r, n = 48000, 16, 4096
    rng = np.random.default_rng(3)
    tbl = rng.normal(size=(r, k)).astype(np.float32)
    gate = (rng.random((r, n)) > 0.999).astype(np.float32)
    cvl = rng.integers(-1, 2, (r, n)).astype(np.float32)
    check(gate, cvl, tbl, k, 1.5)


def test_ragged_n_not_lane_aligned():
    """n that is no power of two or multiple of 128, with end-crossings
    landing near the end of the block."""
    n = 2500
    gate = (RNG.random((R, n)) > 0.995).astype(np.float32)
    cvl = RNG.integers(-1, 2, (R, n)).astype(np.float32)
    check(gate, cvl, TBL, K, 0.5)
    check(gate, None, TBL, K, 1.5)
    # short logical length so end-crossings land in the ragged block too
    check(gate, cvl, TBL, 600, 2.0)


def test_vmap_folds_voices():
    """Voices that share one table (the engine's case) through the same
    vmapped block path."""
    tbl = np.broadcast_to(TBL[:1], TBL.shape)
    check(GATE, ZCV, tbl, K, 1.0)


def test_eligibility_gates():
    """The block path and the per-sample step (scan engine) agree on one
    voice, connected CV and unconnected."""
    from srack_tpu.modules.sample import _step

    n = 1500
    gate = (RNG.random(n) > 0.99).astype(np.float32)
    cvl = RNG.integers(-1, 2, n).astype(np.float32)
    statics, params = SAMPLE.make(CFG, samples=TBL[0], wav_sample_rate=SR)
    params = jax.tree.map(jnp.asarray, params)
    state0 = SAMPLE.init_state(CFG, statics)
    for cv in (cvl, None):
        st_b, (out_b,) = SAMPLE.block(
            CFG, statics, params, state0,
            (jnp.asarray(gate), None if cv is None else jnp.asarray(cv)),
            None, n)

        def body(st, x):
            g, c = x
            st, (o,) = _step(CFG, statics, params, st,
                             (g, None if cv is None else c))
            return st, o

        st_s, out_s = jax.lax.scan(
            body, state0, (jnp.asarray(gate), jnp.asarray(cvl)))
        np.testing.assert_array_equal(np.asarray(out_b), np.asarray(out_s))
        for k in st_s:
            np.testing.assert_array_equal(np.asarray(st_b[k]),
                                          np.asarray(st_s[k]), err_msg=k)


def test_scattered_triggers_slim_general_tier():
    """Per-voice DESYNCHRONIZED random triggers at rate <= 1.0 (the
    heterogeneous-kit workload), including a sub-1 rate and a ragged
    length."""
    rng = np.random.default_rng(77)
    n = 4096 + 100
    gate = (rng.random((R, n)) < 1.0 / 900.0).astype(np.float32)
    check(gate, None, TBL, K, 1.0)
    check(gate, None, TBL, K, 0.5)
