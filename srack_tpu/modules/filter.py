"""Moog-style 4-pole ladder filter.

Mirrors the reference MoogFilterModule (src/synth/filter.rs:11-249), which is
itself the classic musicdsp "Moog VCF variation 1" form: coefficient
computation from normalised cutoff + resonance, four cascaded one-pole
stages, cubic soft-clip on the last stage, and state clamped to [-1, 1]
against denormals (filter.rs:85-91).

Outputs (filter.rs:166-173 port order): 0 = lowpass, 1 = bandpass,
2 = highpass, where the stage math returns (lp, hp, bp) = (b4, x - b4,
3*(b3 - b4)) (filter.rs:82) with x the resonance-fed input.

The reference caches coefficients and recomputes only when (freq, res)
change (filter.rs:59-68).  Here they are recomputed unconditionally -- a
pure function of the same inputs, observationally identical (the initial
all-zero cache is only hit with zero state, where both paths yield zeros)
and branch-free, which is what a vectorised step wants.

Effective cutoff = clamp(freq + cv * exp_amt, 0, 0.9), res clamped to [0, 1]
(filter.rs:211-215).  All math is f32 like the reference.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import AudioConfig
from .base import CV_DTYPE, ModuleDef, const_ports, cv, in_or


def _make(cfg: AudioConfig, freq: float = 0.2, res: float = 0.5, exp_amt: float = 0.5):
    return ("moog",), {"freq": cv(freq), "res": cv(res), "exp_amt": cv(exp_amt)}


def _init_state(cfg: AudioConfig, statics):
    return {"b": jnp.zeros((5,), dtype=CV_DTYPE)}


def moog_coefs(frequency, res):
    """Coefficients from normalised cutoff + resonance (filter.rs:59-68).

    Split from the ladder so unmodulated filters hoist this chain out of
    the per-sample loop via ModuleDef.derive."""
    q0 = 1.0 - frequency
    p = frequency + 0.8 * frequency * q0
    f = p * 2.0 - 1.0
    q = res * (1.0 + 0.5 * q0 * (1.0 - q0 + 5.6 * q0 * q0))
    return p, f, q


def moog_stage(b, audio, p, f, q):
    """One sample of the ladder core.  ``b`` is the [5] stage vector (in
    the voice-kernel shell: a list of five per-voice rows).

    Returns (new_b, lp, hp, bp), ``new_b`` in ``b``'s own form.  Computed
    element by element -- no stack-then-slice of the stage vector, which
    the shell's Triton route cannot lower -- with the same values.
    """
    b0, b1, b2, b3, b4 = (b[i] for i in range(5))
    x = audio - q * b4
    nb1 = (x + b0) * p - b1 * f
    nb2 = (nb1 + b1) * p - b2 * f
    nb3 = (nb2 + b2) * p - b3 * f
    nb4 = (nb3 + b3) * p - b4 * f
    nb4 = nb4 - nb4 * nb4 * nb4 * 0.166667
    nb = [jnp.clip(v, -1.0, 1.0) for v in (x, nb1, nb2, nb3, nb4)]
    lp = nb[4]
    hp = x - nb[4]
    bp = 3.0 * (nb[3] - nb[4])
    new_b = nb if isinstance(b, list) else jnp.stack(nb)
    return new_b, lp, hp, bp


def _derive(cfg: AudioConfig, statics, params, connected):
    res = jnp.clip(params["res"], 0.0, 1.0)
    out = {"res_clip": res}
    if len(connected) < 2 or not connected[1]:
        # CV unconnected: the whole coefficient chain is loop-invariant
        frequency = jnp.clip(params["freq"], 0.0, 0.9)
        p, f, q = moog_coefs(frequency, res)
        out.update({"moog_p": p, "moog_f": f, "moog_q": q})
    return out


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    audio = in_or(ins[0], 0.0)
    if ins[1] is None and "moog_p" in params:
        p, f, q = params["moog_p"], params["moog_f"], params["moog_q"]
    else:
        cv_in = in_or(ins[1], 0.0)
        res = params.get("res_clip")
        if res is None:
            res = jnp.clip(params["res"], 0.0, 1.0)
        frequency = jnp.clip(params["freq"] + cv_in * params["exp_amt"],
                             0.0, 0.9)
        p, f, q = moog_coefs(frequency, res)
    new_b, lp, hp, bp = moog_stage(state["b"], audio, p, f, q)
    return {"b": new_b}, (lp, bp, hp)


_nin, _inlabels = const_ports(2, ("Audio", "CV"))
_nout, _outlabels = const_ports(3, (None, None, None))

MOOG_FILTER = ModuleDef(
    type_name="Moog Filter",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    derive=_derive,
)
