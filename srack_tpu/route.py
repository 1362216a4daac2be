"""Kernel routes: the one place that looks at the platform.

On an NVIDIA GPU the per-sample hot paths -- the whole-patch voice render,
the block engine's serial stage and the training backward pass -- run in
the voice-kernel shell (:mod:`srack_tpu.ops.shell`), compiled through
Pallas's Triton route.  Everywhere else they run as plain XLA programs
(``lax.scan`` over samples).  Sample playback, Freeverb and the block-wise
scans are plain XLA on every platform.

Interpret mode is never chosen here: only a caller that passes
``interpret=True`` (the tests) gets the Pallas interpreter.
"""

from __future__ import annotations

import jax


def voice_kernel() -> bool:
    """True when this platform runs the compiled voice-kernel shell."""
    return jax.default_backend() == "gpu"


def require_voice_kernel(what: str) -> None:
    """Raise unless the compiled shell exists here (``engine="fused"`` and
    friends never fall back to the interpreter)."""
    if not voice_kernel():
        raise ValueError(
            f"{what} needs the voice-kernel shell, which is compiled only "
            f"for NVIDIA GPUs (this backend is {jax.default_backend()!r}); "
            "use engine='auto', 'block' or 'scan' here")
