"""Small shared DSP primitives.

Functional counterparts of the reference's carried-state helpers, usable both
per-sample (inside ``lax.scan`` bodies) and block-wise (on whole [T] arrays).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def transition(last_above: jnp.ndarray, val: jnp.ndarray):
    """Rising-edge detector.

    Functional form of the reference's ``TransitionDetector``
    (src/synth.rs:277-298): fires when the value rises above 0.0 from <= 0.0.
    ``last_above`` initialises to True so a high signal at t=0 does NOT fire
    (src/synth.rs:282-284).

    Returns ``(new_last_above, fired)``.
    """
    above = val > 0.0
    fired = jnp.logical_and(above, jnp.logical_not(last_above))
    return above, fired


def transition_init() -> jnp.ndarray:
    return jnp.asarray(True)


def block_lane(x, lane_shape: tuple, n: int, fill=0.0,
               dtype=jnp.float32):
    """Broadcast a per-sample input to ``(n, *lane_shape)``.

    ``lane_shape`` is taken from a state leaf (``()`` under the block
    engine's vmap over voices).  ``None`` becomes a constant fill (the
    unconnected-input fallback)."""
    target = (n,) + lane_shape
    if x is None:
        return jnp.full(target, fill, dtype=dtype)
    x = jnp.asarray(x)
    x = x.reshape(x.shape + (1,) * (len(target) - x.ndim))
    return jnp.broadcast_to(x, target)


def t_index(n: int, lane_shape: tuple, dtype=jnp.int32):
    """arange(n) shaped (n, 1, ..., 1) to broadcast against lane tiles."""
    return jnp.arange(n, dtype=dtype).reshape((n,) + (1,) * len(lane_shape))


def block_transitions(last_above: jnp.ndarray, vals: jnp.ndarray):
    """Vectorised edge detection over a [T]-leading block.

    Returns ``(new_last_above, fired)`` -- equivalent to folding
    :func:`transition` over the block, computed with one shift instead of a
    scan (the per-sample recurrence ``last = above`` has no feedback).
    ``vals`` is ``(n, *lane)`` with ``last_above`` shaped ``lane``.
    """
    above = vals > 0.0
    prev = jnp.concatenate(
        [jnp.broadcast_to(last_above, above.shape[1:])[None]
         .astype(above.dtype), above[:-1]], axis=0)
    fired = jnp.logical_and(above, jnp.logical_not(prev))
    return above[-1], fired


_TWO32 = 4294967296.0  # 2**32


def _shifted(x, shift: int, axis: int, fill):
    """x shifted ``shift`` positions along ``axis`` (front-filled)."""
    n = x.shape[axis]
    kept = jax.lax.slice_in_dim(x, 0, n - shift, axis=axis)
    pad_shape = list(x.shape)
    pad_shape[axis] = shift
    pad = jnp.full(pad_shape, fill, dtype=x.dtype)
    return jnp.concatenate([pad, kept], axis=axis)


def _log_scan(op, x, axis: int, identity):
    """Inclusive scan by log-step doubling (Hillis-Steele): log2(n) fused
    elementwise passes.  Exact for int dtypes (associative, wrapping); for
    floats it reassociates the sum (the block/scan parity tests' tolerances
    cover that).
    """
    n = x.shape[axis]
    shift = 1
    while shift < n:
        x = op(x, _shifted(x, shift, axis, identity))
        shift <<= 1
    return x


def fast_cumsum(x, axis: int = -1):
    return _log_scan(jnp.add, x, axis % x.ndim, 0)


def fast_cummax(x, axis: int = -1):
    axis = axis % x.ndim
    if jnp.issubdtype(x.dtype, jnp.integer):
        ident = jnp.iinfo(x.dtype).min
    else:
        ident = -jnp.inf
    return _log_scan(jnp.maximum, x, axis, ident)


def forward_fill(values, mask, axis: int = -1):
    """For each position, the most recent ``values`` entry where ``mask``
    held (inclusive).  Returns ``(filled, any_valid)``.

    Log-doubling "last valid value" scan (elementwise passes, no gather).
    """
    axis = axis % values.ndim
    n = values.shape[axis]
    val = values
    ok = mask
    shift = 1
    while shift < n:
        s_val = _shifted(val, shift, axis, 0)
        s_ok = _shifted(ok, shift, axis, False)
        val = jnp.where(ok, val, s_val)
        ok = jnp.logical_or(ok, s_ok)
        shift <<= 1
    return val, ok


def monotone_fill(values, mask, axis: int = -1):
    """:func:`forward_fill` for NON-DECREASING, NON-NEGATIVE ``values``.

    The most recent masked entry of a non-decreasing sequence is the
    running max of the masked entries, so the fill collapses to one
    :func:`fast_cummax` over ``where(mask, values, -1)`` -- 2 ops per
    log-doubling pass instead of forward_fill's 5, and exact/order-free
    (max never reassociates).  Returns ``(filled, any_valid)``; positions
    before the first masked entry hold ``-1``.
    """
    neg = jnp.asarray(-1, values.dtype)
    filled = fast_cummax(jnp.where(mask, values, neg), axis=axis)
    return filled, filled >= 0


def forward_fill_multi(values: tuple, mask, axis: int = -1):
    """:func:`forward_fill` for several arrays sharing one mask.

    Fills every array in ``values`` with its most recent entry where ``mask``
    held, propagating the shared validity once.  Returns
    ``(filled_tuple, any_valid)``.
    """
    axis = axis % mask.ndim
    n = mask.shape[axis]
    vals = list(values)
    ok = mask
    shift = 1
    while shift < n:
        s_ok = _shifted(ok, shift, axis, False)
        for i, v in enumerate(vals):
            s_v = _shifted(v, shift, axis, 0)
            vals[i] = jnp.where(ok, v, s_v)
        ok = jnp.logical_or(ok, s_ok)
        shift <<= 1
    return tuple(vals), ok


def affine_scan(a, b, axis: int = 0):
    """Compose per-element affine maps ``y -> a[t]*y + b[t]`` inclusively.

    Returns ``(A, B)`` with ``y[t] = A[t]*y0 + B[t]`` solving the
    variable-coefficient first-order recurrence ``y[t] = a[t]*y[t-1] + b[t]``
    (cf. :func:`linear_recurrence`, which requires constant ``a``).
    Log-doubling: O(log n) fused elementwise passes.
    """
    axis = axis % b.ndim
    A = jnp.broadcast_to(jnp.asarray(a, b.dtype), b.shape)
    n = b.shape[axis]
    B = b
    shift = 1
    while shift < n:
        A_s = _shifted(A, shift, axis, 1.0)
        B_s = _shifted(B, shift, axis, 0.0)
        B = A * B_s + B
        A = A * A_s
        shift <<= 1
    return A, B


def linear_recurrence(a, b, axis: int = -1):
    """Parallel first-order linear recurrence ``y[t] = a*y[t-1] + b[t]``
    (constant ``a``), zero initial condition.

    Returns ``(A, Y)`` with ``A[t] = a^(t+1)`` so the solution for an
    arbitrary initial value y0 is ``A*y0 + Y``.  Log-doubling composition
    of the affine maps -- the parallel form of e.g. the Freeverb comb
    damping filter."""
    axis = axis % b.ndim
    A = jnp.broadcast_to(jnp.asarray(a, b.dtype), b.shape)
    n = b.shape[axis]
    Y = b
    shift = 1
    while shift < n:
        A_s = _shifted(A, shift, axis, 1.0)
        Y_s = _shifted(Y, shift, axis, 0.0)
        Y = Y_s * A + Y
        A = A_s * A
        shift <<= 1
    return A, Y


def table_lookup(table, idx):
    """``table[idx]`` for a small table; ``idx`` is int, already in [0, K).

    ``table`` is ``[K]``, or inside the voice-kernel shell a list of K
    per-voice rows.  Per sample (a scalar ``idx``, or the shell's rows) the
    lookup is a binary select tree over the index bits: K-1 selects at
    log2(K) dependency depth, so a 16-step sequencer costs 4 serial selects
    on the per-sample chain, and no gather runs inside the shell.  On a
    whole block (``idx`` with a time axis) it is a plain gather.
    """
    if not isinstance(table, (list, tuple)) and jnp.ndim(idx) > 0:
        return jnp.asarray(table)[idx]
    vals = [table[j] for j in range(len(table))]
    # pad to a power of two; pad entries are never selected (idx < K)
    while len(vals) & (len(vals) - 1):
        vals.append(vals[-1])
    bit_pos = 0
    while len(vals) > 1:
        odd = ((idx >> bit_pos) & 1) != 0
        vals = [jnp.where(odd, vals[2 * i + 1], vals[2 * i])
                for i in range(len(vals) // 2)]
        bit_pos += 1
    return jnp.broadcast_to(vals[0], jnp.shape(idx))


def phase_fixed_init():
    """Fixed-point phase accumulator (fast mode): int32 whose *bit pattern*
    is a uint32 fraction of a cycle (1 ulp = 2^-32).  Two's-complement adds
    wrap exactly mod 2^32, so long renders never drift.  int32 (not
    uint32) keeps every conversion a signed one."""
    return jnp.asarray(0, dtype=jnp.int32)


def phase_fixed_to_float(pos: jnp.ndarray) -> jnp.ndarray:
    """Bit-pattern uint32 fraction -> f32 phase in [0, 1)."""
    f = pos.astype(jnp.float32) * (1.0 / _TWO32)
    return jnp.where(f < 0.0, f + 1.0, f)


def delta_to_fixed(delta: jnp.ndarray) -> jnp.ndarray:
    """f32 per-sample phase increment (cycles) -> fixed-point int32.

    ``delta`` is wrapped to [0,1) first; the two branches keep the f32->i32
    conversion in range (values >= 2^31 are represented by their wrapped
    negative bit pattern)."""
    d = jnp.mod(delta, 1.0)
    u = d * _TWO32
    return jnp.where(d < 0.5, u.astype(jnp.int32),
                     (u - _TWO32).astype(jnp.int32))


# sin(pi*s) odd minimax coefficients on [-1, 1], max abs err 5.9e-6 --
# ~170 dB below full scale, far inside the fast-mode drift budget
# (tests/test_precision.py bounds fast-vs-exact at 1e-3 over one second)
_SINPI_ODD = (3.1415278983587682, -5.166401774862824, 2.5427129265355948,
              -0.5818593382178273, 0.0640261396169806)

# exp2 fractional-part minimax on [0, 1), deg 6, max rel err 1.9e-9 --
# pitch error accumulates linearly with render time, so this must sit well
# under the fixed-point delta quantisation (~6e-8 relative)
_EXP2_COEF = (1.0000000018561317, 0.6931469838082407, 0.24022983671380171,
              0.05548333989618637, 0.009678845362499107,
              0.0012439646470418081, 0.00021702400581973962)


def signed_turns(pos: jnp.ndarray) -> jnp.ndarray:
    """int32 fixed-point phase -> signed turns in [-1, 1).

    The two's-complement bit pattern read as a *signed* fraction of a cycle
    differs from the unsigned phase by exactly one cycle on [0.5, 1), which
    drops out of any 1-periodic wave -- no wrap fixup needed."""
    return pos.astype(jnp.float32) * (1.0 / 2147483648.0)


def fast_sinpi(s: jnp.ndarray) -> jnp.ndarray:
    """sin(pi*s) for s in [-1, 1]: 5-term odd polynomial (~10 ops vs the
    libm-grade range reduction XLA emits for sin)."""
    z = s * s
    p = jnp.asarray(_SINPI_ODD[4], s.dtype)
    for k in (3, 2, 1, 0):
        p = p * z + _SINPI_ODD[k]
    return s * p


def fast_exp2(x: jnp.ndarray) -> jnp.ndarray:
    """2**x: deg-6 polynomial on the fractional part + exponent-bit scale.

    The integer part becomes float exponent bits directly (a bitcast, not a
    value conversion); inputs are clamped to the normal-number range,
    generous for audio pitch CV."""
    x = jnp.clip(x, -126.0, 126.0)
    xi = jnp.floor(x)
    f = x - xi
    p = jnp.asarray(_EXP2_COEF[6], x.dtype)
    for k in (5, 4, 3, 2, 1, 0):
        p = p * f + _EXP2_COEF[k]
    e = (xi.astype(jnp.int32) + 127) << 23
    scale = jax.lax.bitcast_convert_type(e, jnp.float32)
    return p * scale


def poly_blep(t: jnp.ndarray, dt: jnp.ndarray) -> jnp.ndarray:
    """polyBLEP band-limiting correction.

    Same piecewise polynomial as the reference (src/synth/oscillator.rs:50-67,
    itself adapted from the public polyBLEP formulation): a 2-sample smoothing
    of the discontinuity at phase 0 with quadratic segments.  Branchless here
    (``where`` chains) so it vectorises over samples and voices.

    No ``dt == 0`` guard is needed: with dt == 0 both region predicates are
    false (t is in [0, 1)), so the selects already yield 0 and never
    propagate the div-by-zero branch values.
    """
    lo = t / dt
    lo_val = lo + lo - lo * lo - 1.0
    hi = (t - 1.0) / dt
    hi_val = hi * hi + hi + hi + 1.0
    return jnp.where(t < dt, lo_val, jnp.where(t > 1.0 - dt, hi_val, 0.0))


def poly_blep_signed(u: jnp.ndarray) -> jnp.ndarray:
    """polyBLEP in the *signed-phase* domain: 7 ops vs ~15.

    ``u`` is the signed distance from the discontinuity in units of dt:
    ``u = s * (0.5 / dt)`` where s is the signed-turns phase (discontinuity
    at s == 0).  Algebraic identity with :func:`poly_blep`: the low branch
    (u in [0,1)) is ``2u - u^2 - 1 = -(1-u)^2`` and the high branch
    (u in (-1,0)) is ``u^2 + 2u + 1 = (1+u)^2``, i.e. both are
    ``sign(-u) * (1 - |u|)^2`` -- one shared quadratic instead of two
    branch polynomials, and no unsigned-phase reconstruction at all.
    Valid for dt <= 0.5 (phase increments at or below Nyquist).
    """
    au = jnp.abs(u)
    w = 1.0 - au
    mag = jnp.where(au < 1.0, w * w, 0.0)
    return jnp.where(u >= 0.0, -mag, mag)
