"""The block-wise scan and lookup primitives of ops/basic vs NumPy.

The block engine's prefix machinery (oscillator phase sums, sequencer edge
counts, trigger fills, Freeverb's damping solve) and whole-block table
lookups are plain XLA (log-doubling scans, gathers); these pin them
against serial NumPy references -- long rows, integer exactness, batched
(vmapped) calls, and every scan kind the modules use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srack_tpu.ops import basic


def _rows(seed, r, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return jnp.asarray(rng.integers(-5, 6, size=(r, n)), dtype)
    return jnp.asarray(rng.normal(size=(r, n)), dtype)


@pytest.mark.parametrize("n", [2048, 5000, 48000])
def test_cumsum_matches_xla(n):
    x = _rows(0, 3, n)
    got = np.asarray(basic.fast_cumsum(x, axis=1))
    want = np.cumsum(np.asarray(x, np.float64), axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_cumsum_int_exact():
    x = _rows(1, 2, 6000, np.int32)
    got = np.asarray(basic.fast_cumsum(x, axis=1))
    np.testing.assert_array_equal(got, np.cumsum(np.asarray(x), axis=1))


def test_cummax_matches():
    x = _rows(2, 2, 5000)
    got = np.asarray(basic.fast_cummax(x, axis=1))
    np.testing.assert_array_equal(got, np.maximum.accumulate(
        np.asarray(x), axis=1))


def test_fill_matches():
    rng = np.random.default_rng(3)
    r, n = 2, 5000
    vals = np.asarray(_rows(4, r, n))
    mask = rng.random((r, n)) < 0.01
    fv, fo = basic.forward_fill(jnp.asarray(vals), jnp.asarray(mask),
                                axis=1)
    want_v = np.zeros_like(vals)
    want_ok = np.zeros_like(mask)
    for i in range(r):
        last, seen = 0.0, False
        for t in range(n):
            if mask[i, t]:
                last, seen = vals[i, t], True
            want_v[i, t], want_ok[i, t] = last, seen
    np.testing.assert_array_equal(np.asarray(fo), want_ok)
    np.testing.assert_array_equal(np.asarray(fv)[want_ok], want_v[want_ok])


def test_affine_matches_serial():
    rng = np.random.default_rng(5)
    n = 4500
    a = jnp.asarray(rng.uniform(0.9, 1.1, (1, n)), jnp.float32)
    b = _rows(6, 1, n)
    A, B = basic.affine_scan(a, b, axis=1)
    y0 = 0.7
    y = y0
    ys = np.empty(n)
    an, bn = np.asarray(a[0], np.float64), np.asarray(b[0], np.float64)
    for t in range(n):
        y = an[t] * y + bn[t]
        ys[t] = y
    got = np.asarray(A[0], np.float64) * y0 + np.asarray(B[0], np.float64)
    np.testing.assert_allclose(got, ys, rtol=3e-4, atol=3e-4)


def test_gather_matches():
    """Whole-block lookups (an index per sample) are a plain gather."""
    rng = np.random.default_rng(7)
    r, n, k = 3, 5000, 400
    table = jnp.asarray(rng.normal(size=(r, k)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, k, size=(r, n)), jnp.int32)
    got = jax.vmap(basic.table_lookup)(table, idx)
    want = np.take_along_axis(np.asarray(table), np.asarray(idx), axis=1)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_gather_int_table():
    """Per-sample lookups (a scalar index under the voice vmap) take the
    select tree; same values as the gather."""
    rng = np.random.default_rng(8)
    table = jnp.asarray(rng.integers(0, 99, size=(1, 64)), jnp.int32)
    idx = jnp.asarray(rng.integers(0, 64, size=(1, 3000)), jnp.int32)
    got = jax.vmap(jax.vmap(basic.table_lookup, in_axes=(None, 0)))(
        table, idx)
    want = np.take_along_axis(np.asarray(table), np.asarray(idx), axis=1)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_vmap_folds_batch_levels():
    """The scans run under the engine's voice vmap: vmapped rows must
    equal the same scan over the 2-D array exactly."""
    x = _rows(9, 8, 4000)
    got = jax.vmap(lambda row: basic.fast_cumsum(row, axis=0))(x)
    want = basic.fast_cumsum(x, axis=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_eligibility_gates():
    """Inside the voice-kernel shell a table is a list of per-voice rows
    (``[VB]`` each) and the index a row: the select tree must give the
    gather's values for a 12-entry (non power of two) table."""
    rng = np.random.default_rng(10)
    k, vb = 12, 32
    table = rng.integers(0, 1 << 20, size=(k, vb)).astype(np.int32)
    idx = rng.integers(0, k, size=(vb,)).astype(np.int32)
    got = basic.table_lookup([jnp.asarray(row) for row in table],
                             jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got), table[idx, np.arange(vb)])


def test_monotone_fill_matches_forward_fill():
    """For non-decreasing non-negative values, the running-max fill gives
    exactly forward_fill's result (float and int), and -1 before the
    first masked entry."""
    rng = np.random.default_rng(9)
    for dtype in (np.float32, np.int32):
        vals = np.cumsum(rng.integers(0, 4, (3, 700)), axis=1).astype(dtype)
        mask = rng.random((3, 700)) < 0.02
        got, ok = basic.monotone_fill(jnp.asarray(vals), jnp.asarray(mask),
                                      axis=1)
        want_v, want_ok = basic.forward_fill(jnp.asarray(vals),
                                             jnp.asarray(mask), axis=1)
        np.testing.assert_array_equal(np.asarray(ok), np.asarray(want_ok))
        np.testing.assert_array_equal(np.asarray(got)[np.asarray(ok)],
                                      np.asarray(want_v)[np.asarray(want_ok)])
        assert (np.asarray(got)[~np.asarray(ok)] == -1).all()
