"""Per-sample parameter automation lanes.

Automation promotes any scalar module param to a per-sample xs lane
(compiler._sample_step overlay).  No reference analogue -- the reference's
sliders are static between UI events (ui.rs module ``ui()`` methods); this
is the DAW-style layer above them.  Semantics pinned here:

* a constant lane is bit-identical to the static param;
* automating an oscillator's ``val`` equals driving its CV input with the
  same array (octs = cv + val is the documented pitch law,
  oscillator.rs:43-48);
* lanes reach the voice-kernel shell (interpret mode) with the same
  results as the scan engine;
* the block engine runs automation too: serial-stage modules stream lanes
  per sample (exact), block-phase modules handle lanes natively when
  declared (``ModuleDef.auto_block_params``) or join the serial stage —
  incl. the classic Freeverb room-size sweep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import srack_tpu as st
from srack_tpu.compiler import compile_patch
from srack_tpu.engine import render_batch, replicate_params
from srack_tpu.ops import fused

CFG = st.AudioConfig(sample_rate=8000, block_size=64, channels=1,
                     precision="fast")
N = 512


def _voice(val=0.0):
    p = st.Patch(CFG)
    osc = p.add("Oscillator", val=val, name="vco")
    flt = p.add("Moog Filter", freq=0.4, res=0.3, name="vcf")
    p.connect(osc, "Sawtooth", flt, "Audio")
    p.connect(flt, 0, p.output, 0)
    return p, osc, flt


def test_constant_lane_matches_static():
    p, osc, _ = _voice(val=-1.0)
    ref, _, _ = st.render(p, N, engine="scan")
    lane = jnp.full((N,), -1.0, jnp.float32)
    got, _, _ = st.render(p, N, automation={(osc, "val"): lane},
                          engine="scan")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_val_automation_equals_cv_drive():
    rng = np.random.default_rng(0)
    lane = jnp.asarray(rng.uniform(-1.5, 0.5, N), jnp.float32)

    p, osc, _ = _voice(val=0.0)
    got, _, _ = st.render(p, N, automation={(osc, "val"): lane},
                          engine="scan")

    q = st.Patch(CFG)
    drv = q.add("Input", name="pitch")
    osc2 = q.add("Oscillator", val=0.0, name="vco")
    flt2 = q.add("Moog Filter", freq=0.4, res=0.3, name="vcf")
    q.connect(drv, 0, osc2, "CV")
    q.connect(osc2, "Sawtooth", flt2, "Audio")
    q.connect(flt2, 0, q.output, 0)
    want, _, _ = st.render(q, N, drivers={drv: lane}, engine="scan")

    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def test_filter_sweep_changes_output():
    p, _, flt = _voice(val=-1.0)
    sweep = jnp.linspace(0.05, 0.9, N, dtype=jnp.float32)
    swept, _, _ = st.render(p, N, automation={(flt, "freq"): sweep},
                            engine="scan")
    still, _, _ = st.render(p, N, engine="scan")
    assert float(jnp.abs(swept - still).max()) > 1e-3


def test_fused_interpret_matches_scan():
    p, osc, _ = _voice(val=0.0)
    lane = jnp.asarray(np.linspace(-1.0, -0.2, N), jnp.float32)
    compiled = compile_patch(p, automation=((osc, "val"),))
    v = 2
    params = replicate_params(p.params(), v)
    want = compiled.render(N, params=params, batched=True, engine="scan",
                           automation={(osc, "val"): lane})[0]
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    lanes = {compiled._auto_key(osc.id, "val"): jnp.broadcast_to(lane,
                                                                 (v, N))}
    run = fused.make_fused_render(compiled, N, interpret=True)
    got = jax.jit(run)(params, state, keys, lanes)[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_block_engine_stage_automation_matches_scan():
    """Automated params on serial-stage modules (Moog freq) stream into
    the stage per sample: block == scan exactly."""
    p, osc, flt = _voice(val=-1.0)
    sweep = jnp.linspace(0.05, 0.9, N, dtype=jnp.float32)
    autos = {(flt, "freq"): sweep}
    want, _, _ = st.render(p, N, automation=autos, engine="scan")
    got, _, _ = st.render(p, N, automation=autos, engine="block")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def test_block_engine_blockphase_automation_matches_scan():
    """Automated params on block-phase modules (oscillator val via the
    prefix-sum path, Multiply constant via stateless broadcast) match the
    scan engine."""
    p = st.Patch(CFG)
    osc = p.add("Oscillator", val=0.0)
    gain = p.add("Multiply", constant=1.0)
    flt = p.add("Moog Filter", freq=0.4, res=0.3)
    p.connect(osc, "Sawtooth", gain, "In1")
    p.connect(gain, 0, flt, "Audio")
    p.connect(flt, 0, p.output, 0)
    rng = np.random.default_rng(3)
    lane_v = jnp.asarray(rng.uniform(-1.5, 0.0, N), jnp.float32)
    lane_g = jnp.asarray(np.linspace(0.2, 1.0, N), jnp.float32)
    autos = {(osc, "val"): lane_v, (gain, "constant"): lane_g}
    want, _, _ = st.render(p, N, automation=autos, engine="scan")
    got, _, _ = st.render(p, N, automation=autos, engine="block")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-6, rtol=1e-6)
    # and auto now picks the block engine for automated batched renders
    compiled = compile_patch(
        p, automation=((osc, "val"), (gain, "constant")))
    assert compiled.auto_engine(batched=True) == "block"


def _reverb_patch():
    cfg = st.AudioConfig(sample_rate=8000, block_size=64, channels=2,
                         precision="fast")
    p = st.Patch(cfg)
    osc = p.add("Oscillator", val=-1.0)
    env = p.add("ADSR", a_sec=0.001, d_sec=0.05, s_val=0.0, r_sec=0.01)
    clk = p.add("Oscillator", val=-6.0)
    vca = p.add("VCA")
    rev = p.add("Freeverb", room_size=0.3, wet=0.8, dry=0.2)
    p.connect(clk, "Square", env, "Gate")
    p.connect(osc, "Sawtooth", vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, rev, "Left")
    p.connect(vca, 0, rev, "Right")
    p.connect(rev, "Left", p.output, 0)
    p.connect(rev, "Right", p.output, 1)
    return p, rev


def test_freeverb_wet_automation_exact_on_block():
    """wet/width/dry apply at the output mix: automated lanes are exact
    per sample on the block engine (VERDICT r2 item 4)."""
    p, rev = _reverb_patch()
    n = 1024
    wet_lane = jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)
    autos = {(rev, "wet"): wet_lane}
    want, _, _ = st.render(p, n, automation=autos, engine="scan")
    got, _, _ = st.render(p, n, automation=autos, engine="block")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.slow
def test_freeverb_room_sweep_on_block_engine():
    """The classic room-size sweep renders on the block engine.  damp/feed
    snapshot at each chunk start (documented piecewise-constant
    approximation); a slow sweep stays close to the scan engine's exact
    per-sample application."""
    p, rev = _reverb_patch()
    n = 2048
    sweep = jnp.linspace(0.1, 0.9, n, dtype=jnp.float32)
    autos = {(rev, "room_size"): sweep}
    want, _, _ = st.render(p, n, automation=autos, engine="scan")
    got, _, _ = st.render(p, n, automation=autos, engine="block")
    # piecewise-chunk feedback vs per-sample: bounded drift, not bitwise
    err = float(jnp.abs(got - want).max())
    scale = float(jnp.abs(want).max())
    assert err <= 0.05 * max(scale, 1e-3), (err, scale)
    # and the sweep audibly differs from the static render
    still, _, _ = st.render(p, n, engine="block")
    assert float(jnp.abs(got - still).max()) > 1e-4


def test_unknown_param_rejected():
    p, osc, _ = _voice()
    with pytest.raises(KeyError):
        compile_patch(p, automation=((osc, "nope"),))
    compiled = compile_patch(p, automation=((osc, "val"),))
    with pytest.raises(KeyError):
        # lane not declared at compile time
        compiled.render(N, automation={(p.output, "x"): jnp.zeros(N)})


def test_stream_and_long_match_offline():
    """Automation lanes split across stream blocks / render_long segments
    must reproduce the single-call render exactly (state-carried lanes)."""
    from srack_tpu.engine import render_long, render_stream

    p, osc, flt = _voice(val=0.0)
    lane_v = jnp.asarray(np.linspace(-1.0, -0.2, N), jnp.float32)
    lane_f = jnp.asarray(np.linspace(0.1, 0.8, N), jnp.float32)
    autos = {(osc, "val"): lane_v, (flt, "freq"): lane_f}
    want, _, _ = st.render(p, N, automation=autos, engine="scan")

    blocks = [a for a, _, _ in render_stream(
        p, n_blocks=N // CFG.block_size, automation=autos)]
    np.testing.assert_allclose(
        np.asarray(jnp.concatenate(blocks, axis=-1)), np.asarray(want),
        atol=1e-6, rtol=1e-6)

    got, _ = render_long(p, N, segment=3 * CFG.block_size, automation=autos)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def test_stream_holds_last_lane_value():
    from srack_tpu.engine import render_stream

    p, osc, _ = _voice(val=0.0)
    short = jnp.full((CFG.block_size,), -1.0, jnp.float32)  # 1 block only
    blocks = [a for a, _, _ in render_stream(
        p, n_blocks=3, automation={(osc, "val"): short})]
    # past the lane's end the param holds -1.0: same as a constant render
    ref_blocks = [a for a, _, _ in render_stream(
        p, n_blocks=3,
        automation={(osc, "val"): jnp.full((3 * CFG.block_size,), -1.0,
                                           jnp.float32)})]
    for g, w in zip(blocks, ref_blocks):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_batched_shared_lane():
    p, osc, _ = _voice(val=0.0)
    lane = jnp.asarray(np.linspace(-1.0, 0.0, N), jnp.float32)
    params = replicate_params(p.params(), 3)
    audio, _, _ = render_batch(p, N, params=params,
                               automation={(osc, "val"): lane})
    assert audio.shape == (3, 1, N)
    np.testing.assert_array_equal(np.asarray(audio[0]),
                                  np.asarray(audio[2]))


def test_noise_automation_joins_serial_stage_with_lane():
    """Automating a param of a make_xs module (Noise) forces it into the
    serial stage; its hoisted noise lane must stream in per sample instead
    of silently becoming x=None (regression)."""
    p = st.Patch(CFG)
    nz = p.add("Noise")
    p.connect(nz, 0, p.output, 0)
    lane = jnp.zeros((N,), jnp.float32)
    auto = {(nz, "seed"): lane}
    compiled = compile_patch(p, automation=tuple(auto))
    prog = compiled.block_program()
    assert nz.id in prog.stage_set
    a_s, _, _ = st.render(p, N, key=3, automation=auto, engine="scan")
    a_b, _, _ = st.render(p, N, key=3, automation=auto, engine="block")
    assert float(np.abs(np.asarray(a_s)).max()) > 0.1
    np.testing.assert_allclose(np.asarray(a_b), np.asarray(a_s),
                               atol=1e-6, rtol=0)


def test_stream_automation_survives_block_size_change():
    """A live set_audio_config block-size change mid-stream continues the
    automation lanes at the consumed-sample cursor (no replay/skip)."""
    cfg = st.AudioConfig(sample_rate=8000, block_size=64, channels=1,
                         precision="fast")
    p = st.Patch(cfg)
    add = p.add("Add", constant=0.0)  # out = In1(0) + constant = the lane
    p.connect(add, 0, p.output, 0)
    n = 64 * 2 + 32 * 2
    lane = jnp.arange(n, dtype=jnp.float32) / n
    stream = st.render_stream(p, automation={(add, "constant"): lane})
    got = []
    for i, (audio, _, _) in enumerate(stream):
        got.append(np.asarray(audio)[0])
        if i == 1:  # after two 64-sample blocks, shrink the block size
            p.set_audio_config(st.AudioConfig(
                sample_rate=8000, block_size=32, channels=1,
                precision="fast"))
            p.connect(add, 0, p.output, 0)  # set_audio_config resets Output
        if sum(map(len, got)) >= n:
            break
    np.testing.assert_allclose(np.concatenate(got), np.asarray(lane),
                               atol=1e-6, rtol=0)
