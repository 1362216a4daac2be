"""Freeverb's ring canonicalization (modules/freeverb.ring_to_chronological).

The block path rotates each delay line from ring order (write index
``idx``) to time order once per render; pinned against ``np.roll`` for
odd line lengths, batched (vmapped) voices and one voice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srack_tpu.modules.freeverb import ring_to_chronological as ring_align


@pytest.mark.parametrize("rows,length", [
    (32, 1214),   # one full tile, odd (non-128-multiple) comb length
    (7, 245),     # padded partial tile, shortest allpass scale
    (64, 128),    # aligned length, two tiles
    (5, 3),       # degenerate tiny line
])
def test_align_rows_matches_numpy_roll(rows, length):
    key = jax.random.PRNGKey(0)
    buf = jax.random.normal(key, (rows, length), jnp.float32)
    idx = jax.random.randint(jax.random.PRNGKey(1), (rows,), 0, length)
    out = np.asarray(jax.jit(jax.vmap(ring_align))(buf, idx))
    want = np.stack([np.roll(np.asarray(buf)[r], -int(idx[r]))
                     for r in range(rows)])
    np.testing.assert_array_equal(out, want)


def test_ring_align_vmap_folds_batch():
    rows, length = 12, 517
    buf = jax.random.normal(jax.random.PRNGKey(2), (rows, length),
                            jnp.float32)
    idx = jax.random.randint(jax.random.PRNGKey(3), (rows,), 0, length)
    out = np.asarray(jax.vmap(ring_align)(buf, idx))
    want = np.stack([np.roll(np.asarray(buf)[r], -int(idx[r]))
                     for r in range(rows)])
    np.testing.assert_array_equal(out, want)


def test_ring_align_unbatched():
    length = 341
    buf = jax.random.normal(jax.random.PRNGKey(4), (length,), jnp.float32)
    out = np.asarray(ring_align(buf, jnp.asarray(7, jnp.int32)))
    np.testing.assert_array_equal(out, np.roll(np.asarray(buf), -7))
