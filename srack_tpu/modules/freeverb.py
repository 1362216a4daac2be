"""Freeverb stereo reverb.

The reference module (src/synth/freeverb.rs) wraps the external ``freeverb
0.1.0`` crate (Cargo.toml:32) and must be reimplemented here (SURVEY.md §2b):
the classic Schroeder/Jezar "Freeverb" topology -- per channel 8 parallel
lowpass-feedback comb filters summed, followed by 4 series allpasses, with
the right channel's delay lines 23 samples longer (stereo spread).  Constants
follow the public Jezar tunings used by that crate: comb lengths 1116..1617,
allpass lengths 556/441/341/225 (at 44.1 kHz; scaled by ``len * sr / 44100``
for other rates), fixed input gain 0.015, wet scale 3.0, dampening scale 0.4,
room scale 0.28 + offset 0.7, allpass feedback 0.5.

Control mapping mirrors the module's setters (freeverb.rs:88-114): the UI
``dampening`` slider spans 0..=2 and multiplies onto the 0.4 scale; freeze
forces feedback 1.0 / dampening 0 / input gain 0; wet1/wet2 encode stereo
width.  Parameter changes are applied between blocks in the reference
(freeverb.rs:208-214) and are constant within one render call here.

State is a set of ring buffers in the scan carry with one write index per
line (exact wraparound forever, no shared-counter overflow).  Core math is
f64 in ``exact`` mode (the crate computes in f64; the module casts f32 in/out,
freeverb.rs:239-240) and f32 in ``fast`` mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import AudioConfig
from .base import CV_DTYPE, ModuleDef, const_ports, cv, in_or

COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASS_TUNINGS = (556, 441, 341, 225)
STEREO_SPREAD = 23
FIXED_GAIN = 0.015
SCALE_WET = 3.0
SCALE_DAMPENING = 0.4
SCALE_ROOM = 0.28
OFFSET_ROOM = 0.7
ALLPASS_FEEDBACK = 0.5


def adjust_length(length: int, sample_rate: int) -> int:
    return max(1, (length * sample_rate) // 44100)


def line_lengths(sample_rate: int):
    """(comb_l[8], comb_r[8], ap_l[4], ap_r[4]) adjusted for sample rate."""
    cl = tuple(adjust_length(t, sample_rate) for t in COMB_TUNINGS)
    cr = tuple(adjust_length(t + STEREO_SPREAD, sample_rate) for t in COMB_TUNINGS)
    al = tuple(adjust_length(t, sample_rate) for t in ALLPASS_TUNINGS)
    ar = tuple(adjust_length(t + STEREO_SPREAD, sample_rate) for t in ALLPASS_TUNINGS)
    return cl, cr, al, ar


def _make(cfg: AudioConfig, dampening: float = 0.5, freeze: bool = False,
          wet: float = 1.0, width: float = 0.5, room_size: float = 0.5,
          dry: float = 0.0):
    params = {
        "dampening": cv(dampening),
        "freeze": jnp.asarray(bool(freeze)),
        "wet": cv(wet),
        "width": cv(width),
        "room_size": cv(room_size),
        "dry": cv(dry),
    }
    return ("freeverb",), params


def _core_dtype(cfg: AudioConfig):
    return jnp.float64 if cfg.exact else jnp.float32


def _init_state(cfg: AudioConfig, statics):
    dt = _core_dtype(cfg)
    cl, cr, al, ar = line_lengths(cfg.sample_rate)
    state = {}
    for name, lens in (("cl", cl), ("cr", cr), ("al", al), ("ar", ar)):
        for i, n in enumerate(lens):
            state[f"{name}{i}"] = jnp.zeros((n,), dtype=dt)
            state[f"{name}{i}_idx"] = jnp.asarray(0, dtype=jnp.int32)
    for i in range(len(cl)):
        state[f"cl{i}_fs"] = jnp.asarray(0.0, dtype=dt)
        state[f"cr{i}_fs"] = jnp.asarray(0.0, dtype=dt)
    return state


def freeverb_gains(params, dtype):
    """Derived per-render gains (the crate's setter math)."""
    f = lambda v: jnp.asarray(v, dtype=dtype)
    frozen = params["freeze"]
    damp = jnp.where(frozen, f(0.0), f(params["dampening"]) * SCALE_DAMPENING)
    feed = jnp.where(frozen, f(1.0),
                     f(params["room_size"]) * SCALE_ROOM + OFFSET_ROOM)
    in_gain = jnp.where(frozen, f(0.0), f(FIXED_GAIN))
    wet = f(params["wet"]) * SCALE_WET
    width = f(params["width"])
    wet1 = wet * (width / 2.0 + 0.5)
    wet2 = wet * ((1.0 - width) / 2.0)
    dry = f(params["dry"])
    return damp, feed, in_gain, wet1, wet2, dry


def _comb_tick(state, key, x, damp, feed):
    buf, idx, fs = state[key], state[f"{key}_idx"], state[f"{key}_fs"]
    out = buf[idx]
    fs = out * (1.0 - damp) + fs * damp
    buf = buf.at[idx].set(x + fs * feed)
    idx = jnp.where(idx + 1 >= buf.shape[0], 0, idx + 1)
    state[key], state[f"{key}_idx"], state[f"{key}_fs"] = buf, idx, fs
    return out


def _allpass_tick(state, key, x):
    buf, idx = state[key], state[f"{key}_idx"]
    delayed = buf[idx]
    out = delayed - x
    buf = buf.at[idx].set(x + delayed * ALLPASS_FEEDBACK)
    idx = jnp.where(idx + 1 >= buf.shape[0], 0, idx + 1)
    state[key], state[f"{key}_idx"] = buf, idx
    return out


def _step(cfg: AudioConfig, statics, params, state, ins, x=None):
    dt = _core_dtype(cfg)
    l_in = in_or(ins[0], 0.0).astype(dt)
    r_in = in_or(ins[1], 0.0).astype(dt)
    damp, feed, in_gain, wet1, wet2, dry = freeverb_gains(params, dt)

    state = dict(state)
    mixed = (l_in + r_in) * in_gain
    out_l = jnp.asarray(0.0, dtype=dt)
    out_r = jnp.asarray(0.0, dtype=dt)
    for i in range(len(COMB_TUNINGS)):
        out_l = out_l + _comb_tick(state, f"cl{i}", mixed, damp, feed)
        out_r = out_r + _comb_tick(state, f"cr{i}", mixed, damp, feed)
    for i in range(len(ALLPASS_TUNINGS)):
        out_l = _allpass_tick(state, f"al{i}", out_l)
        out_r = _allpass_tick(state, f"ar{i}", out_r)

    final_l = (out_l * wet1 + out_r * wet2 + l_in * dry).astype(CV_DTYPE)
    final_r = (out_r * wet1 + out_l * wet2 + r_in * dry).astype(CV_DTYPE)
    return state, (final_l, final_r)


def ring_to_chronological(buf, idx):
    """A ring buffer with write index ``idx`` in time order (``[0]`` =
    oldest = next read): one dynamic slice of the doubled line."""
    return jax.lax.dynamic_slice(jnp.concatenate([buf, buf]), (idx,),
                                 (buf.shape[0],))


def _block(cfg: AudioConfig, statics, params, state, ins, xs, n):
    """Chunk-parallel Freeverb: the delay lines make the recurrence
    *blockwise* parallel -- within a chunk no longer than the shortest
    delay line, every comb/allpass read is at least one chunk old, so a
    whole chunk vectorises; the only true recurrence (the comb damping
    one-pole, freeverb crate comb.tick) is a constant-coefficient linear
    recurrence solved with a log-doubling scan (SURVEY.md §7 step 5 /
    hard part b).

    Ring buffers are normalised to chronological order once per render
    (one dynamic slice per line), processed as shift registers, and
    written back with write index 0 -- state stays interchangeable with
    the per-sample step.
    """
    from ..ops.basic import linear_recurrence

    dt = _core_dtype(cfg)
    cl, cr, al, ar = line_lengths(cfg.sample_rate)
    # two-level chunking: the combs admit chunks up to the shortest *comb*
    # (~1214 @48k), while the short allpasses (~245 min) process each chunk
    # in sub-pieces.  Series causality is preserved: pieces go in time
    # order, and each allpass's delay line sees its writes in time order.
    chunk = min(min(cl), min(cr), n)
    ap_sub = min(min(al), min(ar))

    def lane(x):
        if x is None:
            return jnp.zeros((n,), dt)
        return jnp.broadcast_to(x, (n,)).astype(dt)

    l_in = lane(ins[0])
    r_in = l_in if ins[0] is ins[1] else lane(ins[1])
    damp, feed, in_gain, wet1, wet2, dry = freeverb_gains(params, dt)
    # block-engine automation: gain params may arrive as per-sample [n]
    # lanes.  wet1/wet2/dry apply at the output mix -- moved outside the
    # chunk loop, so they are *exact per sample*.  damp/feed drive the
    # comb recurrences, whose chunk-parallel solve needs them constant
    # within a chunk: they are snapshotted at each chunk START (the same
    # piecewise-constant approximation a block-based host applies when the
    # reference reads sliders once per buffer, freeverb.rs:208-214).
    fb_varies = jnp.ndim(damp) > 0 or jnp.ndim(feed) > 0
    if fb_varies:
        damp = jnp.broadcast_to(damp, (n,)).astype(dt)
        feed = jnp.broadcast_to(feed, (n,)).astype(dt)

    line_keys = ([f"cl{i}" for i in range(len(cl))]
                 + [f"cr{i}" for i in range(len(cr))]
                 + [f"al{i}" for i in range(len(al))]
                 + [f"ar{i}" for i in range(len(ar))])

    hist = {k: ring_to_chronological(state[k], state[f"{k}_idx"])
            for k in line_keys}
    fs = {f"c{ch}{i}": state[f"c{ch}{i}_fs"]
          for ch in "lr" for i in range(len(cl))}

    def make_body(csize):
        """One chunk of ``csize <= chunk`` samples (every delay-line read
        within it predates the chunk, so it vectorises).  Returns the RAW
        reverb outputs; the wet/dry mix happens once over the whole render
        (exact per-sample, including automated wet/width/dry lanes)."""

        def comb_chunk(h, fs0, mixed, dmp, fd):
            y = h[:csize]
            A, Y = linear_recurrence(dmp, y * (1.0 - dmp))
            fs_t = A * fs0 + Y
            w = mixed + fs_t * fd
            return jnp.concatenate([h[csize:], w]), fs_t[-1], y

        def allpass_piece(h, x, m):
            delayed = h[:m]
            out = delayed - x
            w = x + delayed * ALLPASS_FEEDBACK
            return jnp.concatenate([h[m:], w]), out

        def body(carry, xch):
            hists, fss = carry
            if fb_varies:
                lc, rc, dmp, fd = xch
            else:
                lc, rc = xch
                dmp, fd = damp, feed
            mixed = (lc + rc) * in_gain
            hists = dict(hists)
            fss = dict(fss)
            out = {"l": jnp.zeros((csize,), dt),
                   "r": jnp.zeros((csize,), dt)}
            for ch in "lr":
                for i in range(len(cl)):
                    k = f"c{ch}{i}"
                    hists[k], fss[k], y = comb_chunk(
                        hists[k], fss[k], mixed, dmp, fd)
                    out[ch] = out[ch] + y
                # allpasses: sub-pieces no longer than the shortest line
                pieces = []
                for s0 in range(0, csize, ap_sub):
                    m = min(ap_sub, csize - s0)
                    x_piece = out[ch][s0:s0 + m]
                    for i in range(len(al)):
                        k = f"a{ch}{i}"
                        hists[k], x_piece = allpass_piece(
                            hists[k], x_piece, m)
                    pieces.append(x_piece)
                out[ch] = (pieces[0] if len(pieces) == 1
                           else jnp.concatenate(pieces))
            return (hists, fss), (out["l"], out["r"])

        return body

    carry = (hist, fs)
    pieces_l, pieces_r = [], []
    full, rem = divmod(n, chunk)
    if full:
        xs_chunks = (l_in[:full * chunk].reshape(full, chunk),
                     r_in[:full * chunk].reshape(full, chunk))
        if fb_varies:
            # damp/feed snapshot at each chunk start (piecewise-constant)
            offs = jnp.arange(full) * chunk
            xs_chunks = xs_chunks + (damp[offs], feed[offs])
        carry, (fl, fr) = jax.lax.scan(make_body(chunk), carry, xs_chunks)
        pieces_l.append(fl.reshape(-1))
        pieces_r.append(fr.reshape(-1))
    if rem:
        # partial tail chunk: consume exactly ``rem`` samples so carried
        # state stays sample-accurate for continued renders
        xs_tail = (l_in[full * chunk:], r_in[full * chunk:])
        if fb_varies:
            xs_tail = xs_tail + (damp[n - rem], feed[n - rem])
        carry, (fl, fr) = make_body(rem)(carry, xs_tail)
        pieces_l.append(fl)
        pieces_r.append(fr)
    hists_f, fss_f = carry

    new_state = dict(state)
    for k in line_keys:
        new_state[k] = hists_f[k]
        new_state[f"{k}_idx"] = jnp.asarray(0, jnp.int32)
    for ch in "lr":
        for i in range(len(cl)):
            new_state[f"c{ch}{i}_fs"] = fss_f[f"c{ch}{i}"]
    raw_l = pieces_l[0] if len(pieces_l) == 1 else jnp.concatenate(pieces_l)
    raw_r = pieces_r[0] if len(pieces_r) == 1 else jnp.concatenate(pieces_r)
    # wet/dry mix over the whole render: exact per-sample semantics for
    # (possibly automated) wet/width/dry lanes
    out_l = (raw_l * wet1 + raw_r * wet2 + l_in * dry).astype(CV_DTYPE)
    out_r = (raw_r * wet1 + raw_l * wet2 + r_in * dry).astype(CV_DTYPE)
    return new_state, (out_l, out_r)


_nin, _inlabels = const_ports(2, ("Left", "Right"))
_nout, _outlabels = const_ports(2, ("Left", "Right"))

FREEVERB = ModuleDef(
    type_name="Freeverb",
    make=_make,
    num_inputs=_nin,
    num_outputs=_nout,
    input_labels=_inlabels,
    output_labels=_outlabels,
    init_state=_init_state,
    step=_step,
    block=_block,
    # wet/width/dry automate exactly (output-mix lanes); dampening and
    # room_size automate piecewise-constant per chunk (snapshotted at each
    # chunk start -- the comb solve needs in-chunk-constant coefficients)
    auto_block_params=frozenset(
        {"dampening", "wet", "width", "room_size", "dry"}),
)
