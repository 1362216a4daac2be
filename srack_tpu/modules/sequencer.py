"""Grid and Pattern sequencers.

Reference: src/synth/sequencer.rs.

GridSequencer (sequencer.rs:190-246): a piano-roll of up to 64 steps.  The
step pointer advances on a rising edge of the Step input, resets to 0 on a
rising edge of Sync, and wraps when it reaches the sequence length.  A cell
is off, a note, or a "slide" note: note cells emit cv = note/steps_per_octave
with gate 1.0 when held ("slide" passes the raw Step input through as the
gate, so the clock's duty cycle shapes the note); empty cells hold the last
CV with gate 0.  Sync out pulses 1.0 on step 0.

PatternSequencer (sequencer.rs:482-533): 8 trigger rows over the same step
pointer; per row an on-cell emits 1.0, a slide-cell passes the Step input
through, an empty cell emits 0.0.

Accelerator-first: the sequence grid is a traced parameter table
(capacity-sized, with a traced ``n_steps``), so sequence *edits never
recompile* -- per-sample lookups are packed select trees by the carried
step counter (no gather inside the voice-kernel shell).  Cell encoding: 0 = off, 1 = slide, 2 = on (the reference's
Option<(note, hold)> / Option<bool>).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import AudioConfig
from ..ops.basic import (block_lane, block_transitions, fast_cumsum,
                         forward_fill, monotone_fill, table_lookup,
                         transition, transition_init)
from .base import CV_DTYPE, ModuleDef, const_ports, cv, in_or

MAX_STEPS = 64


def _capacity(n_steps: int, requested) -> int:
    """Static table capacity: the smallest multiple of 8 (<= MAX_STEPS)
    holding the sequence.  Table lookups are K-way select chains, so a
    16-step pattern pays 16 selects, not 64; edits within capacity never
    recompile, growing past it does (like resizing in the reference UI)."""
    cap = int(requested) if requested else 0
    cap = max(cap, int(n_steps), 1)
    cap = min(-(-cap // 8) * 8, MAX_STEPS)
    return cap


def _coerce_grid_sequence(sequence, capacity):
    """Accept a list like [None, (note, hold), ...] -> (notes[K], cells[K])."""
    notes = np.zeros((capacity,), dtype=np.int32)
    cells = np.zeros((capacity,), dtype=np.int32)
    if sequence is not None:
        if len(sequence) > capacity:
            raise ValueError(f"sequence longer than capacity {capacity}")
        for i, cell in enumerate(sequence):
            if cell is None:
                continue
            note, hold = cell
            notes[i] = int(note)
            cells[i] = 2 if hold else 1
    return notes, cells


def _grid_make(cfg: AudioConfig, sequence=None, n_steps: int = None,
               octaves: int = 2, steps_per_octave: int = 12,
               capacity: int = None):
    if n_steps is None:
        n_steps = len(sequence) if sequence is not None else MAX_STEPS
    cap = _capacity(max(n_steps, len(sequence) if sequence else 0), capacity)
    notes, cells = _coerce_grid_sequence(sequence, cap)
    params = {
        "notes": jnp.asarray(notes),
        "cells": jnp.asarray(cells),
        "n_steps": jnp.asarray(int(n_steps), dtype=jnp.int32),
        "steps_per_octave": jnp.asarray(int(steps_per_octave), dtype=jnp.int32),
    }
    return ("gridseq", int(octaves), cap), params


def _grid_derive(cfg: AudioConfig, statics, params, connected):
    """Hoist the per-render packed table + CV scale out of the sample loop
    (the K multiply-adds and the reciprocal would otherwise run per
    sample -- see ModuleDef.derive)."""
    spo = params["steps_per_octave"].astype(CV_DTYPE)
    return {"packed_tbl": params["notes"] * 4 + params["cells"],
            "inv_spo": 1.0 / spo}


def _grid_packed(params):
    tbl = params.get("packed_tbl")
    if tbl is None:  # automated-params path skips derive
        tbl = params["notes"] * 4 + params["cells"]
    inv_spo = params.get("inv_spo")
    if inv_spo is None:
        inv_spo = 1.0 / params["steps_per_octave"].astype(CV_DTYPE)
    return tbl, inv_spo


def _grid_init_state(cfg: AudioConfig, statics):
    return {
        "current_step": jnp.asarray(0, dtype=jnp.int32),
        "step_last": transition_init(),
        "sync_last": transition_init(),
        "last_cv": jnp.asarray(0.0, dtype=CV_DTYPE),
    }


def _advance_step(state, step_in, sync_in, n_steps):
    """Shared step-pointer update (sequencer.rs:219-230)."""
    step_last, step_fired = transition(state["step_last"], step_in)
    sync_last, sync_fired = transition(state["sync_last"], sync_in)
    cs = state["current_step"] + step_fired.astype(jnp.int32)
    cs = jnp.where(sync_fired, 0, cs)
    cs = jnp.where(cs >= n_steps, 0, cs)
    return cs, step_last, sync_last


def _advance_step_block(state, step_in, sync_in, n_steps, n):
    """Vectorised step pointer over a [T] block.

    The recurrence (count rising edges, reset on sync edges, wrap at
    ``n_steps``) is a *segmented* prefix count: with +1 increments,
    wrap-to-zero-on-reach equals ``mod n_steps``, and a sync reset restarts
    the count at the last reset index (sequencer.rs:219-230 semantics;
    assumes the carried step < n_steps, which the serial engine maintains).
    """
    step_last, step_edges = block_transitions(state["step_last"], step_in)
    sync_last, sync_edges = block_transitions(state["sync_last"], sync_in)
    e_cum = fast_cumsum(step_edges.astype(jnp.int32), axis=0)  # inclusive
    # edge count at the last sync reset: e_cum is a non-decreasing count,
    # so the fill is a running max (2 ops/pass, exact on int32)
    e_at_reset, has_reset = monotone_fill(e_cum, sync_edges, axis=0)
    base = jnp.where(has_reset, e_cum - e_at_reset,
                     state["current_step"] + e_cum)
    cs = jnp.mod(base, n_steps)
    return cs, step_last, sync_last


def _grid_block(cfg: AudioConfig, statics, params, state, ins, xs, n):
    lane = state["current_step"].shape
    step_in = block_lane(ins[0], lane, n)
    sync_in = block_lane(ins[1], lane, n)
    cs, step_last, sync_last = _advance_step_block(
        state, step_in, sync_in, params["n_steps"], n)
    # one packed table lookup (note<<2 | cell): a plain gather on a
    # whole block (ops/basic.table_lookup)
    packed_tbl, inv_spo = _grid_packed(params)
    packed = table_lookup(packed_tbl, cs)
    cell = packed & 3
    note = packed >> 2
    note_cv = note.astype(CV_DTYPE) * inv_spo
    on = cell > 0
    # forward-fill: empty cells hold the last emitted CV (sequencer.rs:237)
    filled, any_on = forward_fill(note_cv, on, axis=0)
    cv_out = jnp.where(any_on, filled, state["last_cv"]).astype(CV_DTYPE)
    gate_out = jnp.where(on, jnp.where(cell == 2, cv(1.0), step_in), cv(0.0))
    sync_out = jnp.where(cs == 0, cv(1.0), cv(0.0))
    new_state = {
        "current_step": cs[-1],
        "step_last": step_last,
        "sync_last": sync_last,
        "last_cv": cv_out[-1],
    }
    return new_state, (cv_out, gate_out, sync_out)


def _grid_step(cfg: AudioConfig, statics, params, state, ins, x=None):
    step_in = in_or(ins[0], 0.0)
    sync_in = in_or(ins[1], 0.0)
    cs, step_last, sync_last = _advance_step(state, step_in, sync_in,
                                             params["n_steps"])
    # packed select-chain lookup (same as _grid_block): pure register math,
    # so the step runs inside the fused Pallas voice kernel where cs is an
    # (8,128) tile and a real gather would not vectorise
    packed_tbl, inv_spo = _grid_packed(params)
    packed = table_lookup(packed_tbl, cs)
    cell = packed % 4
    note = packed // 4
    note_cv = note.astype(CV_DTYPE) * inv_spo
    on = cell > 0
    cv_out = jnp.where(on, note_cv, state["last_cv"])
    gate_out = jnp.where(on, jnp.where(cell == 2, cv(1.0), step_in), cv(0.0))
    sync_out = jnp.where(cs == 0, cv(1.0), cv(0.0))
    new_state = {
        "current_step": cs,
        "step_last": step_last,
        "sync_last": sync_last,
        "last_cv": cv_out.astype(CV_DTYPE),
    }
    return new_state, (cv_out.astype(CV_DTYPE), gate_out, sync_out)


_grid_nin, _grid_inlabels = const_ports(2, ("Step", "Sync"))
_grid_nout, _grid_outlabels = const_ports(3, ("CV", "Gate", "Sync"))

GRID_SEQUENCER = ModuleDef(
    type_name="Grid Sequencer",
    make=_grid_make,
    num_inputs=_grid_nin,
    num_outputs=_grid_nout,
    input_labels=_grid_inlabels,
    output_labels=_grid_outlabels,
    init_state=_grid_init_state,
    step=_grid_step,
    block=_grid_block,
    derive=_grid_derive,
)


# ---------------------------------------------------------------------------
# Pattern sequencer
# ---------------------------------------------------------------------------

N_ROWS = 8


def _coerce_pattern(pattern, capacity):
    """[[None|True|False]*steps]*8 -> cells[8,K] with 0/1/2 encoding."""
    cells = np.zeros((N_ROWS, capacity), dtype=np.int32)
    if pattern is not None:
        if len(pattern) > N_ROWS:
            raise ValueError(f"pattern has more than {N_ROWS} rows")
        for r, row in enumerate(pattern):
            if len(row) > capacity:
                raise ValueError(f"pattern longer than capacity {capacity}")
            for i, val in enumerate(row):
                if val is None:
                    continue
                cells[r, i] = 2 if val else 1
    return cells


def _pat_make(cfg: AudioConfig, pattern=None, n_steps: int = None,
              capacity: int = None):
    max_row = max((len(r) for r in pattern), default=0) if pattern else 0
    if n_steps is None:
        n_steps = max_row if pattern else MAX_STEPS
    cap = _capacity(max(n_steps, max_row), capacity)
    params = {
        "cells": jnp.asarray(_coerce_pattern(pattern, cap)),
        "n_steps": jnp.asarray(int(n_steps), dtype=jnp.int32),
    }
    return ("patseq", N_ROWS, cap), params


def _pat_derive(cfg: AudioConfig, statics, params, connected):
    """Hoist the 8-row 2-bit packing out of the sample loop: the 7 K-wide
    multiply-adds per sample were the dominant cost of a pattern sequencer
    inside the voice-kernel shell."""
    return {"packed_tbl": _pat_packed(params)}


def _pat_packed(params):
    tbl = params.get("packed_tbl")
    if tbl is not None:  # derived once per render
        return tbl
    cells = params["cells"]  # [..., N_ROWS, K]
    tbl = cells[..., 0, :]
    for r in range(1, N_ROWS):
        tbl = tbl + cells[..., r, :] * (4 ** r)
    return tbl


def _pat_init_state(cfg: AudioConfig, statics):
    return {
        "current_step": jnp.asarray(0, dtype=jnp.int32),
        "step_last": transition_init(),
        "sync_last": transition_init(),
    }


def _pat_block(cfg: AudioConfig, statics, params, state, ins, xs, n):
    lane = state["current_step"].shape
    step_in = block_lane(ins[0], lane, n)
    sync_in = block_lane(ins[1], lane, n)
    cs, step_last, sync_last = _advance_step_block(
        state, step_in, sync_in, params["n_steps"], n)
    # all 8 rows packed 2 bits each into one int32 table -> one
    # select-chain lookup, rows unpacked elementwise (gather-free)
    packed = table_lookup(_pat_packed(params), cs)
    gates = []
    for r in range(N_ROWS):
        col = (packed >> (2 * r)) & 3
        gates.append(jnp.where(col == 2, cv(1.0),
                               jnp.where(col == 1, step_in, cv(0.0))))
    sync_out = jnp.where(cs == 0, cv(1.0), cv(0.0))
    new_state = {
        "current_step": cs[-1],
        "step_last": step_last,
        "sync_last": sync_last,
    }
    return new_state, tuple(gates) + (sync_out,)


def _pat_step(cfg: AudioConfig, statics, params, state, ins, x=None):
    step_in = in_or(ins[0], 0.0)
    sync_in = in_or(ins[1], 0.0)
    cs, step_last, sync_last = _advance_step(state, step_in, sync_in,
                                             params["n_steps"])
    # 8 rows 2-bit-packed into one table, one select-chain lookup (same as
    # _pat_block) -- register math for the fused Pallas voice kernel.
    # the packing itself is hoisted to derive (params["packed_tbl"]);
    # _pat_packed only recomputes it when derive hasn't run (plain step
    # calls outside a compiled render)
    packed = table_lookup(_pat_packed(params), cs)
    sync_out = jnp.where(cs == 0, cv(1.0), cv(0.0))
    new_state = {
        "current_step": cs,
        "step_last": step_last,
        "sync_last": sync_last,
    }
    outs = []
    for r in range(N_ROWS):
        col = (packed >> (2 * r)) & 3
        outs.append(jnp.where(col == 2, cv(1.0),
                              jnp.where(col == 1, step_in, cv(0.0))))
    return new_state, tuple(outs) + (sync_out,)


_pat_nin, _pat_inlabels = const_ports(2, ("Step", "Sync"))
_pat_nout, _pat_outlabels = const_ports(
    N_ROWS + 1, tuple(str(i) for i in range(N_ROWS)) + ("Sync",))

PATTERN_SEQUENCER = ModuleDef(
    type_name="Pattern Sequencer",
    make=_pat_make,
    num_inputs=_pat_nin,
    num_outputs=_pat_nout,
    input_labels=_pat_inlabels,
    output_labels=_pat_outlabels,
    init_state=_pat_init_state,
    step=_pat_step,
    block=_pat_block,
    derive=_pat_derive,
)
