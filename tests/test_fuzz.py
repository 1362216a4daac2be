"""Randomized patch fuzzing (SURVEY.md §4 implication d).

Random module graphs (including feedback cycles) are rendered through all
three engines and, where the oracle supports the modules, against the
NumPy oracle.  The generator mirrors the spirit of the reference's
1000-shuffle planner test, extended to full renders.
"""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import srack_tpu as st
from srack_tpu.oracle import oracle_render

# types the oracle implements deterministically (no Noise)
FUZZ_TYPES = [
    "Oscillator", "Moog Filter", "ADSR", "VCA", "Mono Mixer", "Add",
    "Subtract", "Multiply", "Non-Linear", "Grid Sequencer",
    "Pattern Sequencer", "Freeverb",
]


def random_patch(seed: int, buffer_feedback=False, precision="exact",
                 types=FUZZ_TYPES):
    rng = random.Random(seed)
    cfg = st.AudioConfig(sample_rate=4800, block_size=32, channels=2,
                         precision=precision, buffer_feedback=buffer_feedback)
    p = st.Patch(cfg)
    n_modules = rng.randint(3, 9)
    mods = []
    for _ in range(n_modules):
        t = rng.choice(types)
        kwargs = {}
        if t == "Oscillator":
            kwargs["val"] = rng.uniform(-6, 1)
        elif t == "Moog Filter":
            kwargs = dict(freq=rng.uniform(0, 1), res=rng.uniform(0, 0.9),
                          exp_amt=rng.uniform(0, 1))
        elif t == "ADSR":
            kwargs = dict(a_sec=rng.uniform(0, 0.01),
                          d_sec=rng.uniform(0, 0.01),
                          s_val=rng.uniform(0, 1),
                          r_sec=rng.uniform(0, 0.01))
        elif t in ("Add", "Subtract", "Multiply"):
            kwargs["constant"] = rng.uniform(-2, 2)
        elif t == "Non-Linear":
            kwargs["constant"] = rng.uniform(0.5, 2)
        elif t == "Grid Sequencer":
            n_steps = rng.randint(2, 12)
            seq = [None if rng.random() < 0.3 else
                   (rng.randint(0, 24), rng.random() < 0.5)
                   for _ in range(n_steps)]
            kwargs = dict(sequence=seq, n_steps=n_steps)
        elif t == "Pattern Sequencer":
            n_steps = rng.randint(2, 12)
            pat = [[rng.choice([None, True, False])
                    for _ in range(n_steps)] for _ in range(8)]
            kwargs = dict(pattern=pat, n_steps=n_steps)
        elif t == "Noise":
            kwargs = dict(seed=rng.randint(0, 99))
        elif t == "Sample":
            frames = rng.randint(16, 2048)  # crosses the 1024 kernel split
            kwargs = dict(
                samples=[rng.uniform(-1, 1) for _ in range(frames)],
                wav_sample_rate=rng.choice([2400, 4800, 9600]))
        mods.append(p.add(t, **kwargs))
    # random wiring (40% density), including potential cycles
    for sink in mods + [p.output]:
        inst = p[sink]
        for port in range(len(inst.inputs)):
            if rng.random() < 0.4 and mods:
                src = rng.choice(mods)
                n_out = p[src].mdef.num_outputs(cfg, p[src].statics)
                if n_out:
                    p.connect(src, rng.randrange(n_out), sink, port)
    # ensure the output hears something
    if all(c is None for c in p[p.output].inputs) and mods:
        src = next((m for m in mods
                    if p[m].mdef.num_outputs(cfg, p[m].statics)), None)
        if src is not None:
            p.connect(src, 0, p.output, 0)
    return p


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_buffer_mode_matches_oracle(seed):
    p = random_patch(seed, buffer_feedback=True)
    n = 32 * 4
    got, _, _ = st.render(p, n, engine="scan")
    want = oracle_render(p, n)
    np.testing.assert_allclose(np.asarray(got), want, atol=3e-4, rtol=0)


@pytest.mark.parametrize("seed", range(10, 22))
def test_fuzz_block_matches_scan(seed):
    p = random_patch(seed)
    n, v = 160, 2
    compiled = st.compile_patch(p)
    params = st.replicate_params(compiled.default_params, v)
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(seed), v)
    a_scan, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                   batched=True, engine="scan")
    a_blk, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                  batched=True, engine="block")
    assert np.isfinite(np.asarray(a_scan)).all()
    np.testing.assert_allclose(np.asarray(a_blk), np.asarray(a_scan),
                               atol=3e-4, rtol=0)


@pytest.mark.parametrize("seed,n", [(30, 37), (31, 101), (32, 163),
                                    (33, 97)])
def test_fuzz_fused_odd_n_matches_scan(seed, n):
    """Fast-mode fused kernel (interpret) vs scan at renders whose length
    is NOT a multiple of any chunk size: audio AND final state must agree
    (regression coverage for the padded-tail snapshot path)."""
    from srack_tpu.ops import fused

    register_types = [t for t in FUZZ_TYPES if t != "Freeverb"]
    p = random_patch(seed, precision="fast", types=register_types)
    compiled = st.compile_patch(p)
    assert compiled.fused_eligible()
    v = 2
    params = st.replicate_params(compiled.default_params, v)
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(seed), v)
    a_scan, _, s_scan = compiled.render(n, params=params, state=state,
                                        key=keys, batched=True,
                                        engine="scan")
    run = jax.jit(fused.make_fused_render(compiled, n, unroll=4,
                                          interpret=True))
    a_fus, _, s_fus = run(params, state, keys, {})
    np.testing.assert_allclose(np.asarray(a_fus), np.asarray(a_scan),
                               atol=2e-5, rtol=0)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(b, np.float64), np.asarray(a, np.float64), atol=2e-5),
        s_scan, s_fus)


@pytest.mark.parametrize("seed", range(40, 46))
def test_fuzz_samples_and_noise_block_matches_scan(seed):
    """Random graphs INCLUDING Sample players (16..2048-frame tables,
    mismatched WAV rates) and Noise: the block engine's gather/lane paths
    must match scan.  Noise is deterministic here (keyed threefry hoisted
    identically by both engines), so comparisons stay exact."""
    p = random_patch(seed, types=FUZZ_TYPES + ["Sample", "Noise"])
    n, v = 160, 2
    compiled = st.compile_patch(p)
    params = st.replicate_params(compiled.default_params, v)
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(seed), v)
    a_scan, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                   batched=True, engine="scan")
    a_blk, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                  batched=True, engine="block")
    a_scan, a_blk = np.asarray(a_scan), np.asarray(a_blk)
    assert ((~np.isfinite(a_scan)) == (~np.isfinite(a_blk))).all()
    np.testing.assert_allclose(np.where(np.isfinite(a_blk), a_blk, 0.0),
                               np.where(np.isfinite(a_scan), a_scan, 0.0),
                               atol=3e-4, rtol=0)


def test_fuzz_nonlinear_inf_parity():
    """Signed pow can legitimately produce inf (0^negative — the reference's
    `0.0f32.powf(-b)` is inf too, math.rs:202-206): engines and oracle must
    agree on the non-finite samples, not hide them.  Seed 213 wires
    Non-Linear's exponent input to its own output (feedback), driving the
    exponent negative while In1 stays unconnected (0.0)."""
    p = random_patch(213)
    n, v = 160, 2
    compiled = st.compile_patch(p)
    params = st.replicate_params(compiled.default_params, v)
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(213), v)
    a_scan, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                   batched=True, engine="scan")
    a_blk, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                  batched=True, engine="block")
    a_scan, a_blk = np.asarray(a_scan), np.asarray(a_blk)
    assert (~np.isfinite(a_scan)).sum() > 0  # the seed exercises the edge
    assert ((~np.isfinite(a_scan)) == (~np.isfinite(a_blk))).all()
    assert np.allclose(a_blk, a_scan, atol=3e-4, equal_nan=True)

    # oracle agreement on the buffer-mode variant of the same seed
    p2 = random_patch(213, buffer_feedback=True)
    got, _, _ = st.render(p2, 128, engine="scan")
    want = oracle_render(p2, 128)
    assert (~np.isfinite(want)).sum() > 0
    assert np.allclose(np.asarray(got), want, atol=3e-4, equal_nan=True)


def test_fuzz_self_edge_mixer_matches_oracle():
    """Fuzz seed 307: a Mono Mixer wired to ITSELF while another input is
    live.  The reference cannot run this patch at all (a self-edge
    deadlocks the buffer RwLock, mixer.rs:102-120), so the framework
    defines the semantics: a self-edge is a 1-cycle and reads the previous
    block (buffer mode) / sample like any broken feedback edge.  The
    oracle's input-major accumulation used to alias its own output buffer
    here and doubled the self-term."""
    p = random_patch(307, buffer_feedback=True)
    n = 128
    got, _, _ = st.render(p, n, engine="scan")
    want = oracle_render(p, n)
    np.testing.assert_allclose(np.asarray(got), want, atol=3e-4, rtol=0)

    # minimal form: out = in + self, previous-block self term
    cfg = st.AudioConfig(sample_rate=4800, block_size=4, channels=1,
                         precision="exact", buffer_feedback=True)
    q = st.Patch(cfg)
    const = q.add("Add", constant=1.0)      # both inputs open -> 0 + 1.0
    mix = q.add("Mono Mixer")
    q.connect(const, 0, mix, 0)
    q.connect(mix, 0, mix, 1)               # self-edge
    q.connect(mix, 0, q.output, 0)
    audio, _, _ = st.render(q, 12, engine="scan")
    # block b outputs 1 + (previous block's value): 1, 2, 3, ...
    expect = np.repeat(np.arange(1.0, 4.0), 4)[None, :]
    np.testing.assert_allclose(np.asarray(audio), expect, atol=1e-6)
    np.testing.assert_allclose(oracle_render(q, 12), expect, atol=1e-6)


def test_noise_path_matches_oracle_with_injected_lanes():
    """Noise itself is excluded from sample-exact comparison (the reference
    RNG is non-reproducible), but the *processing* of noise is testable:
    inject the engine's own threefry lanes into the oracle."""
    cfg = st.AudioConfig(sample_rate=4800, block_size=32, channels=1,
                         precision="exact", buffer_feedback=True)
    p = st.Patch(cfg)
    noise = p.add("Noise", seed=7)
    flt = p.add("Moog Filter", freq=0.4, res=0.5)
    gain = p.add("Multiply", constant=0.8)
    p.connect(noise, 0, flt, "Audio")
    p.connect(flt, 0, gain, "In1")
    p.connect(gain, 0, p.output, 0)
    n = 128
    compiled = st.compile_patch(p)
    key = jax.random.PRNGKey(3)
    got, _, _ = compiled.render(n, key=key, engine="scan")
    lanes = compiled._make_xs(compiled.default_params, key, n, {})
    want = oracle_render(p, n, noise={k: np.asarray(v)
                                      for k, v in lanes.items()})
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [100, 101, 102, 103])
def test_fuzz_multirate_and_stereo(seed):
    """Fuzz across sample rates and channel counts, block vs scan."""
    rng = random.Random(seed)
    sr = rng.choice([4410, 8000, 22050])
    p = random_patch(seed)
    cfg = st.AudioConfig(sample_rate=sr, block_size=32, channels=2,
                         precision="exact")
    # rebuild the same topology at the new rate via save/load
    from srack_tpu.io import save_patch, load_patch
    doc = save_patch(p)
    import json as _json
    d = _json.loads(doc)
    d["config"]["sample_rate"] = sr
    q = load_patch(_json.dumps(d))
    n, v = 96, 2
    compiled = st.compile_patch(q)
    params = st.replicate_params(compiled.default_params, v)
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(seed), v)
    a_scan, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                   batched=True, engine="scan")
    a_blk, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                  batched=True, engine="block")
    assert np.isfinite(np.asarray(a_scan)).all()
    np.testing.assert_allclose(np.asarray(a_blk), np.asarray(a_scan),
                               atol=3e-4, rtol=0)
