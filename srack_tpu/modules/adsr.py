"""ADSR envelope generator.

Faithful branchless reproduction of the reference's per-sample state machine
(src/synth/adsr.rs:134-217), including its quirks:

* linear segments with phase increments ``1/(sr * t_sec)`` -- a zero time
  constant yields +inf and the stage completes on the same sample;
* retrigger from Attack resets phase and latches the current level into
  ``r_val`` (adsr.rs:157-160) so the restarted attack ramps from it;
* a rising edge during Release enters Attack but the release increment is
  still added that sample, and a same-sample release completion overrides
  back to idle with ``r_val = 0`` (adsr.rs:187-199);
* output law per stage (adsr.rs:202-208) evaluated on the *post-update*
  mode, then ``r_val``/``from_a_val`` track the emitted level
  (adsr.rs:209-213).

Modes are encoded as int32: 0=None 1=Attack 2=Decay 3=Sustain 4=Release.
The ``match`` becomes mode-indexed ``where`` chains: every branch's update is
computed unconditionally (cheap elementwise math) and selected -- compiler-friendly
control flow instead of the reference's data-dependent branching.

**Phase representation (accelerator-first).**  The reference accumulates ``phase +=
inc`` per sample; this module instead carries an int32 stage counter ``k``
and an entry offset ``p0`` and evaluates ``phase = p0 + float(k)*inc``.
Counter phase is what makes the envelope *segment-parallel*: the whole
trajectory between gate edges is a closed form of ``k``, so the block
implementation below runs attack/decay/sustain/release as fused elementwise
ramps over the entire render (plus a handful of log-doubling scans), and --
because every engine evaluates the *same* float expression -- scan, fused
and block engines agree bitwise on stage-boundary samples.  The drift vs the
reference's iterated f32 accumulation is O(k * 2^-25) in the phase (the
oracle-parity tests bound it), with stage boundaries possibly shifted by one
sample on long stages -- inside the "float tolerance" contract of SURVEY §7.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import AudioConfig
from ..ops.basic import transition, transition_init
from .base import CV_DTYPE, ModuleDef, const_ports, cv, in_or


def _make(cfg: AudioConfig, a_sec: float = 0.0, d_sec: float = 0.5,
          s_val: float = 0.25, r_sec: float = 0.5):
    params = {
        "a_sec": cv(a_sec),
        "d_sec": cv(d_sec),
        "s_val": cv(s_val),
        "r_sec": cv(r_sec),
    }
    return ("adsr",), params


def _init_state(cfg: AudioConfig, statics):
    return {
        "mode": jnp.asarray(0, dtype=jnp.int32),
        "k": jnp.asarray(0, dtype=jnp.int32),
        "p0": jnp.asarray(0.0, dtype=CV_DTYPE),
        "r_val": jnp.asarray(0.0, dtype=CV_DTYPE),
        "from_a_val": jnp.asarray(0.0, dtype=CV_DTYPE),
        "gate_last": transition_init(),
    }


def stage_incs(params, sample_rate):
    """Per-stage phase increments ``1/(sr * t_sec)`` (adsr.rs:143,166,183).

    Reads the derived entries when present (three reciprocals per sample
    otherwise, see ModuleDef.derive)."""
    if "inc_a" in params:
        return params["inc_a"], params["inc_d"], params["inc_r"]
    sr = jnp.asarray(sample_rate, dtype=CV_DTYPE)
    return (1.0 / (sr * params["a_sec"]),
            1.0 / (sr * params["d_sec"]),
            1.0 / (sr * params["r_sec"]))


def _derive(cfg: AudioConfig, statics, params, connected):
    sr = jnp.asarray(cfg.sample_rate, dtype=CV_DTYPE)
    return {"inc_a": 1.0 / (sr * params["a_sec"]),
            "inc_d": 1.0 / (sr * params["d_sec"]),
            "inc_r": 1.0 / (sr * params["r_sec"])}


def adsr_step_core(params, state, gate, sample_rate):
    """One sample of the envelope.  Shared with the block/Pallas engines."""
    mode, k, p0 = state["mode"], state["k"], state["p0"]
    r_val, from_a_val = state["r_val"], state["from_a_val"]
    gate_last, fired = transition(state["gate_last"], gate)
    gate_hi = gate > 0.0
    inc_a, inc_d, inc_r = stage_incs(params, sample_rate)
    kf = (k + 1).astype(CV_DTYPE)
    zero = jnp.zeros_like(p0)
    zk = jnp.zeros_like(k)

    # candidate next-phase per stage: phase = p0 + (k+1)*inc
    pa = p0 + kf * inc_a
    pd = p0 + kf * inc_d
    pr = jnp.where(gate_hi, inc_r, p0 + kf * inc_r)

    # --- mode 0: idle ------------------------------------------------------
    mode_n = jnp.where(gate_hi, 1, 0)
    k_n = jnp.where(gate_hi, zk, k)
    p0_n = jnp.where(gate_hi, zero, p0)
    ph_n = zero

    # --- mode 1: attack ----------------------------------------------------
    a_done = pa >= 1.0
    retrig_a = jnp.logical_and(jnp.logical_not(a_done), fired)
    mode_a = jnp.where(a_done, 2, 1)
    k_a = jnp.where(jnp.logical_or(a_done, retrig_a), zk, k + 1)
    p0_a = jnp.where(jnp.logical_or(a_done, retrig_a), zero, p0)
    ph_a = jnp.where(jnp.logical_or(a_done, retrig_a), zero, pa)
    rval_a = jnp.where(retrig_a, from_a_val, r_val)

    # --- mode 2: decay -----------------------------------------------------
    d_done = pd >= 1.0
    mode_d = jnp.where(fired, 1, jnp.where(d_done, 3, 2))
    k_d = jnp.where(jnp.logical_or(fired, d_done), zk, k + 1)
    p0_d = jnp.where(jnp.logical_or(fired, d_done), zero, p0)
    ph_d = jnp.where(jnp.logical_or(fired, d_done), zero, pd)

    # --- mode 3: sustain ---------------------------------------------------
    gate_lo = jnp.logical_not(gate_hi)
    leave_s = jnp.logical_or(gate_lo, fired)
    mode_s = jnp.where(fired, 1, jnp.where(gate_lo, 4, 3))
    k_s = jnp.where(leave_s, zk, k)
    p0_s = jnp.where(leave_s, zero, p0)
    ph_s = zero

    # --- mode 4: release ---------------------------------------------------
    r_done = pr >= 1.0
    mode_r = jnp.where(r_done, 0, jnp.where(gate_hi, 1, 4))
    # gate-high retrigger keeps the release increment as the attack entry
    # offset (adsr.rs:187-199): phase' = inc_r, counted from k'=0
    k_r = jnp.where(jnp.logical_or(r_done, gate_hi), zk, k + 1)
    p0_r = jnp.where(r_done, zero, jnp.where(gate_hi, pr, p0))
    ph_r = jnp.where(r_done, zero, pr)
    rval_r = jnp.where(r_done, zero, r_val)

    def by_mode(v0, v1, v2, v3, v4):
        return jnp.where(
            mode == 0, v0,
            jnp.where(mode == 1, v1,
                      jnp.where(mode == 2, v2,
                                jnp.where(mode == 3, v3, v4))))

    new_mode = by_mode(mode_n, mode_a, mode_d, mode_s, mode_r)
    new_k = by_mode(k_n, k_a, k_d, k_s, k_r)
    new_p0 = by_mode(p0_n, p0_a, p0_d, p0_s, p0_r)
    new_phase = by_mode(ph_n, ph_a, ph_d, ph_s, ph_r)
    r_mid = by_mode(r_val, rval_a, r_val, r_val, rval_r)

    out = adsr_out_law(new_mode, new_phase, r_mid, params["s_val"])

    new_r_val = jnp.where(new_mode != 1, out, r_mid)
    new_from_a = jnp.where(new_mode == 1, out, from_a_val)

    new_state = {
        "mode": new_mode.astype(jnp.int32),
        "k": new_k.astype(jnp.int32),
        "p0": new_p0.astype(CV_DTYPE),
        "r_val": new_r_val.astype(CV_DTYPE),
        "from_a_val": new_from_a.astype(CV_DTYPE),
        "gate_last": gate_last,
    }
    return new_state, out


def adsr_out_law(mode, phase, r_mid, s_val):
    """Post-update output law (adsr.rs:202-208), shared with the block impl
    so both engines evaluate the identical float expression."""
    out = jnp.where(
        mode == 0, 0.0,
        jnp.where(mode == 1, r_mid + (1.0 - r_mid) * phase,
                  jnp.where(mode == 2,
                            s_val + (1.0 - s_val) * (1.0 - phase),
                            jnp.where(mode == 3, s_val,
                                      s_val * (1.0 - phase)))))
    return out.astype(CV_DTYPE)


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    gate = in_or(ins[0], 0.0)
    new_state, out = adsr_step_core(params, state, gate, cfg.sample_rate)
    return new_state, (out,)


def _block(cfg: AudioConfig, statics, params, state, ins, xs, n):
    from ..ops.adsr_block import adsr_block
    return adsr_block(cfg, params, state, ins, n)


_nin, _inlabels = const_ports(1, ("Gate",))
_nout, _outlabels = const_ports(1, (None,))

ADSR = ModuleDef(
    type_name="ADSR",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    block=_block,
    derive=_derive,
)
