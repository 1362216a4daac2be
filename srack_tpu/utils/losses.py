"""Audio losses for differentiable sound matching.

The reference is not differentiable at all; this is a build-side capability
unlocked by the pure-JAX engine (cf. DiffMoog-style sound matching,
PAPERS.md): every render is differentiable w.r.t. module parameters, so a
patch can be *fitted* to a target sound with gradient descent.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp


def stft_mag(x: jnp.ndarray, frame: int, hop: int) -> jnp.ndarray:
    """Magnitude STFT of a [n] signal with a Hann window."""
    n = x.shape[-1]
    n_frames = max(1, (n - frame) // hop + 1)
    idx = jnp.arange(n_frames)[:, None] * hop + jnp.arange(frame)[None, :]
    frames = x[..., idx] * jnp.hanning(frame)
    return jnp.abs(jnp.fft.rfft(frames, axis=-1))


def multiscale_spectral_loss(
        pred: jnp.ndarray, target: jnp.ndarray,
        frames: Sequence[int] = (256, 512, 1024), eps: float = 1e-6):
    """Multi-resolution STFT loss (L1 on magnitudes + log magnitudes)."""
    loss = 0.0
    for frame in frames:
        if pred.shape[-1] < frame:
            continue
        hop = frame // 4
        pm = stft_mag(pred, frame, hop)
        tm = stft_mag(target, frame, hop)
        loss = loss + jnp.mean(jnp.abs(pm - tm))
        loss = loss + jnp.mean(
            jnp.abs(jnp.log(pm + eps) - jnp.log(tm + eps)))
    return loss


def waveform_l2(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean((pred - target) ** 2)
