"""Segment-parallel (whole-block) ADSR evaluation.

The reference envelope (src/synth/adsr.rs:134-217) is a per-sample state
machine, but between gate events its trajectory is piecewise linear:
attack/decay/release phases are ``p0 + j*inc`` ramps of the stage counter
and the only cross-event coupling is the level a retriggered attack ramps
from -- an *affine* function of the previous stretch's level.  That makes
the whole envelope computable in parallel:

1. gate edges (plus a couple of carried-state anchors) partition time into
   *stretches*; per stretch the attack/decay/release lengths are closed
   forms of the stage increments (``stage_len`` probes the exact same float
   comparison the per-sample step uses, so stage boundaries agree bitwise
   with the scan engine's counter-phase step);
2. the reference's retrigger quirks (a retrigger landing exactly on the
   attack-completion sample is *lost*, adsr.rs:146-156; a retrigger from
   Release keeps the release increment as the attack entry phase, and a
   same-sample release completion overrides to idle, adsr.rs:187-199) make
   edge classification depend on the preceding stretch -- resolved by a
   fixed-point ``lax.while_loop`` that provably terminates in at most
   #events rounds (each round finalizes at least the earliest unstable
   event) and converges in ~2 rounds on musical gates;
3. the retrigger-level recurrence is solved with one log-doubling
   :func:`..ops.basic.affine_scan`; every per-sample output is then a fused
   elementwise expression of the sample index.

All discrete decisions (stage boundaries, mode trajectory) are functions of
integer sample counts and per-voice constants only -- never of the affine
level -- so scan and block engines produce identical mode trajectories; the
level itself differs only by float reassociation in the affine composition
(ulp-scale, covered by the engine-agreement tolerances).

Not handled: a carried state of (mode=Release, gate_last=high), which the
step function can never produce (a high gate in Release immediately leaves
the mode); such a hand-loaded state falls back to plain release semantics.

NOTE on engine placement: the block engine's default classification now
runs ADSR in the per-sample serial stage instead of through this module
(block_engine.SERIAL_TYPES): the envelope is ~15 ops per sample there,
while the fixed-point classify needs ~10 full-block elementwise passes per
round.
This whole-block formulation remains the right tool when per-sample
execution is unavailable or the envelope is evaluated standalone (it is
exactly the scan engine's trajectory, oracle-verified), and it documents
the segment decomposition the Sample player also uses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..modules.base import CV_DTYPE
from .basic import (affine_scan, block_lane, block_transitions,
                    forward_fill_multi, t_index)


def _prev(x, first):
    """x shifted one sample later along axis 0; slot 0 = ``first`` (lane)."""
    first = jnp.broadcast_to(first, x.shape[1:]).astype(x.dtype)
    return jnp.concatenate([first[None], x[:-1]], axis=0)


# sentinel for "stage never completes within reach": must exceed any
# reachable rel = t + carried_k + 1 (NOT just the block length -- a carried
# mid-decay state can have boundaries far past this block), while keeping
# sums of two sentinels inside int32
BIG = 1_000_000_000


def _stage_len(p0, inc):
    """min{j >= 1 : fl(p0 + fl(j*inc)) >= 1}, clamped to ``BIG``.

    Uses the *identical* float expression as ``adsr_step_core``'s phase
    (``p0 + float(k+1)*inc``), probing a window around the closed-form
    estimate so float division error can't shift the boundary.  Beyond
    q ~ 1.4e7 the f32 phase itself can no longer resolve single samples
    (the scan engine has the same granularity), so the window suffices.
    """
    q = (1.0 - p0) / inc
    q = jnp.where(jnp.isfinite(q), jnp.clip(q, 1.0, float(BIG)), float(BIG))
    j0 = jnp.clip(jnp.floor(q).astype(jnp.int32) - 3, 1, BIG)
    best = jnp.full_like(j0, BIG)
    for d in (7, 6, 5, 4, 3, 2, 1, 0):  # descending: smallest ok j wins
        j = jnp.clip(j0 + d, 1, BIG)
        ok = p0 + j.astype(CV_DTYPE) * inc >= 1.0
        best = jnp.where(ok, j, best)
    return best


# chunk size for long renders: the fills below materialize O(log C)
# temporaries of the chunk's size, so the whole-render working set must be
# bounded (an unchunked 48k-sample render at 1k voices peaked at >100 GB of
# XLA temporaries).  Chunks chain exactly -- the machinery is carried-state
# exact (proven bitwise by the buffer-mode engine tests at 64-sample blocks).
CHUNK = 2048


def adsr_block(cfg, params, state, ins, n):
    lane = state["r_val"].shape
    gate = block_lane(ins[0], lane, n)
    full, rem = divmod(n, CHUNK)
    if full < 2:
        return _adsr_block_impl(cfg, params, state, gate, n)

    g = gate[:full * CHUNK].reshape((full, CHUNK) + gate.shape[1:])

    def body(st, gc):
        st2, (o,) = _adsr_block_impl(cfg, params, st, gc, CHUNK)
        return st2, o

    state, outs = jax.lax.scan(body, state, g)
    outs = outs.reshape((full * CHUNK,) + gate.shape[1:])
    if rem:
        state, (tail,) = _adsr_block_impl(cfg, params, state,
                                          gate[full * CHUNK:], rem)
        outs = jnp.concatenate([outs, tail], axis=0)
    return state, (outs,)


def _adsr_block_impl(cfg, params, state, gate, n):
    from ..modules.adsr import adsr_out_law, stage_incs

    lane = state["r_val"].shape
    h = gate > 0.0
    gate_last_new, f = block_transitions(state["gate_last"], gate)
    h_prev = _prev(h, state["gate_last"])
    t = t_index(n, lane)
    inc_a, inc_d, inc_r = stage_incs(params, cfg.sample_rate)
    s_val = params["s_val"]
    m_c = state["mode"]
    zero = jnp.zeros(lane, CV_DTYPE)

    # ---- carried-state virtual stretch (covers samples before any event) --
    # anchor so rel = t - a continues the carried stage counter k
    a_virt = jnp.where(m_c == 3, -1, -(state["k"] + 1)).astype(jnp.int32)
    d1_v = jnp.where(m_c == 1, _stage_len(state["p0"], inc_a), 0)
    p0a_v = state["p0"]
    p0d_v = jnp.where(m_c == 2, state["p0"], zero)
    p0r_v = jnp.where(m_c == 4, state["p0"], zero)
    ts_v = jnp.where(m_c == 3, 0,
                     jnp.where(m_c == 4, 0,
                               jnp.minimum(d1_v + _stage_len(p0d_v, inc_d),
                                           BIG)))
    tr_v = jnp.where(m_c == 4, 0, BIG)  # mode 4: release already running
    idle_v = m_c == 0

    jd0 = _stage_len(zero, inc_d)   # in-block decay length (offset 0)
    jr0 = _stage_len(zero, inc_r)   # in-block release length
    # attack lengths for the only two attack entry phases an in-block event
    # can produce (classify's new_p0 is 0 or inc_r by construction): lets
    # stretch_arrays select between two per-voice constants instead of
    # running the 8-probe _stage_len over the whole [n, lane] block -- the
    # probes were ~40 elementwise passes per classify round
    ja0 = _stage_len(zero, inc_a)
    jar = _stage_len(jnp.broadcast_to(inc_r, lane).astype(CV_DTYPE), inc_a)

    # events: gate edges + carried-idle level trigger at t=0
    # (idle enters Attack on gate *level*, synth.rs mode None arm)
    anchor0 = jnp.logical_and(t == 0, jnp.logical_and(idle_v, h))
    ev = jnp.logical_or(f, anchor0)

    def stretch_arrays(eff, ovr, p0s):
        """Per-sample stretch descriptors given the current event labels."""
        boundary = jnp.logical_or(eff, ovr)
        (a_f, p0a_f, idle_f), has = forward_fill_multi(
            (t, p0s, ovr.astype(jnp.int32)), boundary, axis=0)
        a_t = jnp.where(has, a_f, a_virt)
        idle_t = jnp.where(has, idle_f == 1, idle_v)
        p0a_t = jnp.where(has, p0a_f, p0a_v)
        d1_t = jnp.where(has, jnp.where(p0a_f == 0.0, ja0, jar), d1_v)
        ts_t = jnp.where(has, jnp.minimum(d1_t + jd0, BIG), ts_v)
        p0d_t = jnp.where(has, zero, p0d_v)
        p0r_t = jnp.where(has, zero, p0r_v)
        jr_t = jnp.where(has, jr0, _stage_len(p0r_v, inc_r))
        rel = t - a_t

        # first gate-low sample after sustain entry -> release start
        det = jnp.logical_and(
            jnp.logical_not(idle_t),
            jnp.logical_and(jnp.logical_not(h),
                            jnp.logical_and(rel >= ts_t + 1,
                                            jnp.logical_or(h_prev,
                                                           rel == ts_t + 1))))
        (tr_f, tag_f), det_ok = forward_fill_multi((t, a_t), det, axis=0)
        tr_valid = jnp.logical_and(det_ok, tag_f == a_t)
        tr_t = jnp.where(tr_valid, tr_f - a_t,
                         jnp.where(has, BIG, tr_v))

        is_start = jnp.logical_and(has,
                                   jnp.logical_and(t == a_t,
                                                   jnp.logical_not(idle_t)))
        live = jnp.logical_not(idle_t)
        in_attack = jnp.logical_and(live, jnp.logical_and(rel >= 1,
                                                          rel < d1_t))
        in_decay = jnp.logical_and(live, jnp.logical_and(rel >= d1_t,
                                                         rel < ts_t))
        in_sust = jnp.logical_and(live, jnp.logical_and(rel >= ts_t,
                                                        rel < tr_t))
        in_rel = jnp.logical_and(live, jnp.logical_and(rel >= tr_t,
                                                       rel < tr_t + jr_t))
        post_mode = jnp.where(
            jnp.logical_or(is_start, in_attack), 1,
            jnp.where(in_decay, 2,
                      jnp.where(in_sust, 3, jnp.where(in_rel, 4, 0))))
        return dict(a=a_t, p0a=p0a_t, p0d=p0d_t, p0r=p0r_t, d1=d1_t,
                    ts=ts_t, tr=tr_t, jr=jr_t, rel=rel, idle=idle_t,
                    is_start=is_start, post_mode=post_mode)

    def classify(eff, ovr, p0s):
        sa = stretch_arrays(eff, ovr, p0s)
        em = _prev(sa["post_mode"], m_c)        # entry mode at each sample
        a_p = _prev(sa["a"], a_virt)
        d1_p = _prev(sa["d1"], d1_v)
        # retrigger landing exactly on the attack-completion sample is lost
        lost = jnp.logical_and(ev, jnp.logical_and(em == 1,
                                                   t - a_p == d1_p))
        over = jnp.logical_and(ev, jnp.logical_and(em == 4, inc_r >= 1.0))
        eff_ev = jnp.logical_and(ev, jnp.logical_not(
            jnp.logical_or(lost, over)))
        p0_ev = jnp.where(jnp.logical_and(eff_ev, em == 4), inc_r, zero)
        # a gate still high one sample after an override restarts from idle
        spawn = jnp.logical_and(_prev(over, jnp.zeros(lane, bool)), h)
        new_eff = jnp.logical_or(eff_ev, spawn)
        new_p0 = jnp.where(eff_ev, p0_ev, zero)
        return new_eff, over, new_p0

    def loop_cond(c):
        return c[4]

    def loop_body(c):
        eff, ovr, p0s, i, _ = c
        ne, no, np0 = classify(eff, ovr, p0s)
        changed = jnp.logical_or(
            jnp.any(ne != eff),
            jnp.logical_or(jnp.any(no != ovr), jnp.any(np0 != p0s)))
        return (ne, no, np0, i + 1,
                jnp.logical_and(changed, i < jnp.int32(n + 2)))

    eff, ovr, p0s, _, _ = jax.lax.while_loop(
        loop_cond, loop_body,
        (ev, jnp.zeros_like(ev), jnp.zeros((n,) + lane, CV_DTYPE),
         jnp.int32(0), jnp.asarray(True)))

    sa = stretch_arrays(eff, ovr, p0s)
    rel_f = sa["rel"].astype(CV_DTYPE)
    pm = sa["post_mode"]

    # ---- retrigger-level affine recurrence --------------------------------
    em = _prev(pm, m_c)
    a_p = _prev(sa["a"], a_virt)
    p0a_p = _prev(sa["p0a"], p0a_v)
    rel_p = (t - 1) - a_p
    phase_prev = jnp.where(rel_p == 0, p0a_p,
                           p0a_p + rel_p.astype(CV_DTYPE) * inc_a)
    # constant previous-sample output for non-attack entry modes
    i_p = rel_p - _prev(sa["d1"], d1_v)
    j_p = rel_p - _prev(sa["tr"], tr_v)
    p0d_p, p0r_p = _prev(sa["p0d"], p0d_v), _prev(sa["p0r"], p0r_v)
    # stage-entry samples have phase exactly p0 (guards 0*inf when a time
    # constant is zero, adsr.rs:143's 1/0 -> +inf increment)
    pd_prev = jnp.where(i_p == 0, p0d_p,
                        p0d_p + i_p.astype(CV_DTYPE) * inc_d)
    pr_prev = jnp.where(j_p == 0, p0r_p,
                        p0r_p + j_p.astype(CV_DTYPE) * inc_r)
    const_prev = adsr_out_law(em, jnp.where(em == 2, pd_prev, pr_prev),
                              zero, s_val)
    # start at t=0: "out[-1]" is the carried level -- from_a_val when the
    # carried mode is Attack (retrigger-from-attack reads it), else r_val
    at0 = t == 0
    base0 = jnp.where(m_c == 1, state["from_a_val"], state["r_val"])
    alpha = jnp.where(sa["is_start"],
                      jnp.where(at0, 0.0,
                                jnp.where(em == 1, 1.0 - phase_prev, 0.0)),
                      1.0).astype(CV_DTYPE)
    beta = jnp.where(sa["is_start"],
                     jnp.where(at0, base0,
                               jnp.where(em == 1, phase_prev, const_prev)),
                     0.0).astype(CV_DTYPE)
    # y0 = the carried attack base: the virtual stretch (a continuing
    # attack) ramps from the latched r_val, not from the current level
    y0 = state["r_val"]
    A, B = affine_scan(alpha, beta, axis=0)
    L = A * y0 + B

    # ---- per-sample output -------------------------------------------------
    i_t = sa["rel"] - sa["d1"]
    j_t = sa["rel"] - sa["tr"]
    phase = jnp.where(
        pm == 1,
        jnp.where(sa["is_start"], sa["p0a"],
                  sa["p0a"] + rel_f * inc_a),
        jnp.where(pm == 2,
                  jnp.where(i_t == 0, sa["p0d"],
                            sa["p0d"] + i_t.astype(CV_DTYPE) * inc_d),
                  jnp.where(j_t == 0, sa["p0r"],
                            sa["p0r"] + j_t.astype(CV_DTYPE) * inc_r)))
    out = adsr_out_law(pm, phase, L, s_val)

    # ---- carried state ------------------------------------------------------
    pm_e, rel_e = pm[-1], sa["rel"][-1]
    k_end = jnp.where(pm_e == 1, jnp.where(sa["is_start"][-1], 0, rel_e),
                      jnp.where(pm_e == 2, rel_e - sa["d1"][-1],
                                jnp.where(pm_e == 4, rel_e - sa["tr"][-1],
                                          0)))
    p0_end = jnp.where(pm_e == 1, sa["p0a"][-1],
                       jnp.where(pm_e == 2, sa["p0d"][-1],
                                 jnp.where(pm_e == 4, sa["p0r"][-1], zero)))
    r_val_end = jnp.where(pm_e == 1, L[-1], out[-1])
    ff, ok = forward_fill_multi((out,), pm == 1, axis=0)
    from_a_end = jnp.where(ok[-1], ff[0][-1], state["from_a_val"])

    new_state = {
        "mode": pm_e.astype(jnp.int32),
        "k": k_end.astype(jnp.int32),
        "p0": p0_end.astype(CV_DTYPE),
        "r_val": r_val_end.astype(CV_DTYPE),
        "from_a_val": from_a_end.astype(CV_DTYPE),
        "gate_last": gate_last_new,
    }
    return new_state, (out,)
