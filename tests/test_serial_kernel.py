"""Direct tests of the voice-kernel shell (ops/shell.run) on a toy step,
in Pallas interpret mode on the CPU.

The shell runs the sample loop inside one program per voice block, unrolled
by hand: lengths that are not a multiple of the unroll run a remainder
after the loop, and voice counts that are not a multiple of ``VB`` are
padded.  The final state must be the state after exactly ``n`` samples
(segmented renders continue from it).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from srack_tpu.ops import shell


def decay_step(params, state, x):
    acc = state["acc"] * jnp.float32(0.5) + x["in"] * params["g"]
    flip = jnp.logical_xor(state["flag"], x["in"] > 0.5)
    return ({"acc": acc, "flag": flip},
            {"out": acc, "out2": acc * jnp.float32(2.0)})


def decay_ref(xs, g):
    v, n = xs.shape
    acc = np.zeros(v, np.float32)
    flag = np.zeros(v, bool)
    out = np.zeros((v, n), np.float32)
    for t in range(n):
        acc = (acc * np.float32(0.5) + xs[:, t] * g).astype(np.float32)
        flag = flag ^ (xs[:, t] > 0.5)
        out[:, t] = acc
    return out, acc, flag


@pytest.mark.parametrize("n,v,unroll", [
    (256, 8, 8),     # whole unroll groups
    (100, 8, 3),     # loop + remainder (100 = 33*3 + 1)
    (70, 40, 4),     # voices padded to two blocks, remainder of 2
    (5, 3, 8),       # shorter than one unroll group: remainder only
])
def test_ragged_n_matches_serial_reference(n, v, unroll):
    rng = np.random.default_rng(0)
    xs = rng.random((v, n)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, v).astype(np.float32)
    params = {"g": jnp.asarray(g)}
    state = {"acc": jnp.zeros((v,), jnp.float32),
             "flag": jnp.zeros((v,), bool)}
    outs, fs = shell.run(decay_step, n, params, state,
                         {"in": jnp.asarray(xs)}, ["out", "out2"],
                         unroll=unroll, interpret=True)
    want_out, want_acc, want_flag = decay_ref(xs, g)
    # rtol: XLA may contract ``acc * 0.5 + x * g`` into one FMA
    np.testing.assert_allclose(np.asarray(outs["out"]), want_out, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(outs["out2"]), want_out * 2,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(fs["acc"]), want_acc, rtol=1e-6)
    assert fs["flag"].dtype == jnp.bool_
    np.testing.assert_array_equal(np.asarray(fs["flag"]), want_flag)


def vector_step(params, state, x):
    """A leaf with a trailing dim arrives as a list of per-voice rows."""
    b = state["b"]
    nb = [b[1], b[2], b[0] + x["in"] * params["w"][0] + params["w"][1]]
    return {"b": nb}, {"out": b[0] + b[1] + b[2]}


def test_trailing_dim_leaves_travel_as_rows():
    v, n = 5, 9
    rng = np.random.default_rng(1)
    xs = rng.random((v, n)).astype(np.float32)
    w = rng.random((v, 2)).astype(np.float32)
    b0 = rng.random((v, 3)).astype(np.float32)
    outs, fs = shell.run(vector_step, n, {"w": jnp.asarray(w)},
                         {"b": jnp.asarray(b0)}, {"in": jnp.asarray(xs)},
                         ["out"], interpret=True)
    b = b0.copy()
    want = np.zeros((v, n), np.float32)
    for t in range(n):
        want[:, t] = b[:, 0] + b[:, 1] + b[:, 2]
        b = np.stack([b[:, 1], b[:, 2],
                      b[:, 0] + xs[:, t] * w[:, 0] + w[:, 1]], axis=1)
    np.testing.assert_allclose(np.asarray(outs["out"]), want, rtol=1e-6)
    assert fs["b"].shape == (v, 3)
    np.testing.assert_allclose(np.asarray(fs["b"]), b, rtol=1e-6)


@pytest.mark.parametrize("v", [1, 31, 32, 33, 1024])
def test_voices_pad_to_block(v):
    assert shell.padded_voices(v) % shell.VB == 0
    assert v <= shell.padded_voices(v) < v + shell.VB
