"""The waveform read of Sample playback: a plain gather per voice.

``modules/sample._block`` reads ``params["samples"][idx]`` under the
engine's voice vmap.  These pin that batched gather against numpy
indexing across the index patterns sample playback produces
(sample.rs:215-236): monotone ramps, trigger restarts, end-of-sample
resets, divergent per-voice positions and uniform-random indices.
"""

import jax
import jax.numpy as jnp
import numpy as np


def _gather(t, i):
    return t[i]


def _run(table, idx):
    return np.asarray(jax.jit(jax.vmap(_gather))(
        jnp.asarray(table, jnp.float32), jnp.asarray(idx, jnp.int32)))


def _want(table, idx):
    return np.take_along_axis(np.asarray(table, np.float32),
                              np.asarray(idx), axis=1)


K = 5000
R = 4
N = 4096
TBL = np.random.default_rng(0).normal(size=(R, K)).astype(np.float32)


def test_monotone_ramp():
    idx = (np.arange(N)[None] * 1.2 + np.arange(R)[:, None] * 777) % (K - 1)
    idx = idx.astype(np.int32)
    np.testing.assert_array_equal(_run(TBL, idx), _want(TBL, idx))


def test_trigger_restarts():
    period = 900 + 123 * np.arange(R)[:, None]
    idx = np.minimum((np.arange(N)[None] % period), K - 1).astype(np.int32)
    np.testing.assert_array_equal(_run(TBL, idx), _want(TBL, idx))


def test_divergent_rates():
    rng = np.random.default_rng(1)
    starts = rng.integers(0, K, (R, 1))
    rates = np.exp2(rng.uniform(-1, 2, (R, 1)))  # 0.5 .. 4
    idx = ((starts + np.arange(N)[None] * rates) % (K - 1)).astype(np.int32)
    np.testing.assert_array_equal(_run(TBL, idx), _want(TBL, idx))


def test_uniform_random_worst_case():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, K, (R, N)).astype(np.int32)
    np.testing.assert_array_equal(_run(TBL, idx), _want(TBL, idx))


def test_edges_and_tiny_table():
    idx = np.zeros((1, N), np.int32)
    idx[0, :10] = K - 1
    np.testing.assert_array_equal(_run(TBL[:1], idx), _want(TBL[:1], idx))
    # a 7-frame table
    tbl = TBL[:2, :7]
    idx2 = np.random.default_rng(3).integers(0, 7, (2, N)).astype(np.int32)
    np.testing.assert_array_equal(_run(tbl, idx2), _want(tbl, idx2))


def test_small_table_static_path():
    """Drum-sized and power-of-two-boundary table lengths."""
    rng = np.random.default_rng(5)
    for k in (400, 1024, 1025):
        tbl = rng.normal(size=(R, k)).astype(np.float32)
        idx = rng.integers(0, k, (R, N)).astype(np.int32)
        np.testing.assert_array_equal(_run(tbl, idx), _want(tbl, idx))


def test_unpadded_shapes():
    # odd voice count and a length that is no power of two
    tbl = TBL[:3]
    idx = (np.arange(2500)[None] % (K - 1)).astype(np.int32)
    idx = np.broadcast_to(idx, (3, 2500)).copy()
    np.testing.assert_array_equal(_run(tbl, idx), _want(tbl, idx))


def test_vmap_folds_batch_into_rows():
    rng = np.random.default_rng(4)
    tbl = jnp.asarray(TBL)
    idx = jnp.asarray(rng.integers(0, K, (R, N)), jnp.int32)
    got = jax.vmap(_gather)(tbl, idx)
    want = jnp.take_along_axis(tbl, idx, axis=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_eligibility_gates():
    """A table padded past its logical length (``max_len``) is never read
    beyond ``length``: after the end crossing the player holds
    ``samples[0]`` (sample.rs:223-226), so an all-ones waveform padded
    with zeros plays only ones."""
    from srack_tpu.config import AudioConfig
    from srack_tpu.modules.sample import SAMPLE

    cfg = AudioConfig(sample_rate=48000, block_size=1024, channels=1,
                      precision="fast")
    statics, params = SAMPLE.make(cfg, samples=np.ones(100, np.float32),
                                  wav_sample_rate=96000.0, max_len=256)
    params = jax.tree.map(jnp.asarray, params)
    gate = (np.arange(1000) % 300 == 1).astype(np.float32)
    _, (out,) = SAMPLE.block(cfg, statics, params,
                             SAMPLE.init_state(cfg, statics),
                             (jnp.asarray(gate), None), None, 1000)
    np.testing.assert_array_equal(np.asarray(out), np.ones(1000, np.float32))
