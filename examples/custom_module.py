"""Define, register and render a user module type (docs/MODULES.md).

The reference is extended by implementing the ``SynthModule`` trait and
adding it to ``get_catalog()`` (src/synth.rs:216-263, 421-515); here a
module type is a :class:`ModuleDef` of pure functions.  This example adds
a **ring modulator with an internal carrier** -- a classic modular effect
the reference catalog does not have -- declares it ``register_safe`` so
whole patches containing it still run on the fused Pallas voice kernel,
and renders a bell-like tone through it on every engine.

Run: PYTHONPATH=/root/repo python examples/custom_module.py [out.wav]
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

import srack_tpu as st
from srack_tpu.modules.base import CV_DTYPE, const_ports, cv, in_or
from srack_tpu.ops.basic import fast_sinpi


def _make(cfg, freq_hz: float = 700.0, mix: float = 1.0):
    return ("ringmod",), {"freq_hz": cv(freq_hz), "mix": cv(mix)}


def _init_state(cfg, statics):
    # carrier phase in turns; f32 is plenty for an audio-rate modulator
    return {"phase": jnp.zeros((), dtype=CV_DTYPE)}


def _derive(cfg, statics, params, connected):
    # per-sample phase increment is loop-invariant -> hoist the divide
    return {"dphase": params["freq_hz"] / cfg.sample_rate}


def _step(cfg, statics, params, state, ins, x=None):
    audio = in_or(ins[0], 0.0)
    phase = jnp.mod(state["phase"] + params["dphase"], 1.0)
    # sin(pi*(2p-1)) = -sin(2*pi*p): negate to make the carrier start
    # rising from 0 like a textbook sine
    carrier = -fast_sinpi(2.0 * phase - 1.0)
    wet = audio * carrier
    out = audio + params["mix"] * (wet - audio)
    return {"phase": phase}, (out.astype(CV_DTYPE),)


_nin, _inlabels = const_ports(1, ("Audio",))
_nout, _outlabels = const_ports(1, (None,))

RING_MOD = st.register_module(st.ModuleDef(
    type_name="Ring Modulator",
    make=_make,
    num_inputs=_nin,
    input_labels=_inlabels,
    num_outputs=_nout,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    derive=_derive,
    register_safe=True,  # elementwise jnp math only -> fused-kernel legal
))


def build(cfg: st.AudioConfig) -> st.Patch:
    p = st.Patch(cfg)
    osc = p.add("Oscillator", val=-1.0)           # 220 Hz
    env = p.add("ADSR", a_sec=0.01, d_sec=0.6, s_val=0.0, r_sec=0.2)
    gate = p.add("Oscillator", val=-6.0)          # ~6.9 Hz retrigger clock
    ring = p.add("Ring Modulator", freq_hz=563.0, mix=0.8)
    vca = p.add("VCA")
    p.connect(gate, "Square", env, "Gate")
    p.connect(osc, "Sine", ring, "Audio")
    p.connect(ring, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    return p


def main() -> None:
    cfg = st.AudioConfig(sample_rate=48000, block_size=1024, channels=1,
                         precision="fast")
    patch = build(cfg)
    compiled = st.compile_patch(patch)
    print("fused-eligible with the custom type:", compiled.fused_eligible())

    n = 48000
    audio, _, _ = st.render(patch, n, engine="scan")
    a = np.asarray(audio)
    print(f"rendered {a.shape} peak={np.abs(a).max():.3f} "
          f"rms={np.sqrt((a ** 2).mean()):.3f}")

    # the same patch, batched across 8 detuned voices (the voice-kernel
    # shell picks this up on a GPU; elsewhere auto takes block/scan)
    v = 8
    params = st.replicate_params(patch.params(), v)
    osc_id = [i.id for i in patch
              if i.mdef.type_name == "Oscillator"][0]
    params[osc_id]["val"] = params[osc_id]["val"] + jnp.linspace(-0.1, 0.1, v)
    batch, _, _ = st.render_batch(patch, n, params=params)
    print("batched:", tuple(batch.shape), "engine:",
          compiled.auto_engine(batched=True))

    if len(sys.argv) > 1:
        st.io.write_wav(sys.argv[1], a, cfg.sample_rate)
        print("wrote", sys.argv[1])


if __name__ == "__main__":
    main()
