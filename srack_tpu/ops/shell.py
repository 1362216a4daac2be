"""The voice-kernel shell: one Pallas kernel around a per-sample step.

Three hot paths run a per-sample step for many voices at once: the
whole-patch voice render (ops/fused.py), the block engine's serial stage
(block_engine.py) and the training backward pass (ops/fused_vjp.py).  This
module is the one kernel shell they share, compiled for NVIDIA GPUs through
Pallas's Triton route (``backend="triton"``):

* the grid runs over blocks of ``VB`` voices only, one voice per thread;
* the sample loop runs inside the program (``lax.fori_loop``, unrolled by
  hand so the compiler can overlap consecutive samples), with module state
  as the loop carry -- state never leaves registers, and the final state is
  written after exactly ``n`` samples;
* per-sample lanes are time-major ``[n, Vp]``, so each sample's load or
  store for a block is one coalesced row;
* a per-voice leaf ``[V, *rest]`` travels as rows ``[prod(rest), Vp]``.  In
  the kernel a leaf with trailing dims is a nested Python list of ``[VB]``
  rows: module code indexes it and never slices an array, because the
  Triton route lowers no ``slice`` and concatenates only two one-wide
  operands.  Bools travel (and are carried) as int32.

The step is the same module code the scan engine runs: module steps are
shape-polymorphic jnp, so a per-voice "scalar" is simply a ``[VB]`` row.

``step(params, state, x_t) -> (new_state, outs)``: ``x_t`` maps lane keys
to this sample's values, ``outs`` maps output keys to this sample's values.

The backward pass (:func:`differentiable`) checkpoints the state at every
``CHUNK``-sample boundary in the forward.  Its kernel runs one program per
voice block, walks the chunks in reverse, recomputes each chunk's
per-sample states into a global-memory buffer (an extra output the program
alone touches; it stays in L2) and sweeps the chunk backwards through the
step's VJP, accumulating parameter cotangents in registers.  Discrete state
(int phase, bool edge detectors) is a constant of the linearisation (zero
derivative almost everywhere); lanes get zero cotangents.
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp
from jax import dtypes as jax_dtypes
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..modules.base import CV_DTYPE

# voices per program: a power of two (Triton's block rule), one warp, one
# voice per thread.  1,024 voices make 32 programs for the H100's 132 SMs;
# occupancy is not tuned yet.
VB = 32
NUM_WARPS = 1
# backward checkpoint interval (samples per recomputed chunk)
CHUNK = 128


def padded_voices(v: int) -> int:
    return -(-max(v, 1) // VB) * VB


def _carry_dtype(dtype):
    return jnp.int32 if dtype == jnp.bool_ else dtype


def _is_float(dtype) -> bool:
    return jnp.issubdtype(dtype, jnp.floating)


def _nest(elems, rest):
    """Flat C-order rows -> nested lists shaped ``rest`` (a lone row when
    ``rest`` is empty)."""
    if not rest:
        return elems[0]
    width = len(elems) // rest[0]
    return [_nest(elems[i * width:(i + 1) * width], rest[1:])
            for i in range(rest[0])]


def _flat(value, rest):
    """Inverse of :func:`_nest`.  An array with trailing dims is indexed
    element by element -- that lowers only in interpret mode, so modules
    return per-element lists (see modules/filter.py moog_stage)."""
    if not rest:
        return [value]
    return [e for i in range(rest[0]) for e in _flat(value[i], rest[1:])]


class _Spec:
    """Static layout of one pytree of per-voice leaves ``[V, *rest]``."""

    def __init__(self, tree):
        leaves, self.treedef = jax.tree.flatten(tree)
        self.dtypes = tuple(jnp.dtype(l.dtype) for l in leaves)
        self.rests = tuple(tuple(l.shape[1:]) for l in leaves)
        self.sizes = tuple(math.prod(r) for r in self.rests)
        # flat element positions belonging to float leaves
        self.float_pos = []
        i = 0
        for d, size in zip(self.dtypes, self.sizes):
            if _is_float(d):
                self.float_pos.extend(range(i, i + size))
            i += size

    def rows(self, tree, vp):
        """Leaves -> ``[R, Vp]`` rows (voices padded, bools as int32)."""
        out = []
        for leaf, size in zip(jax.tree.leaves(tree), self.sizes):
            a = jnp.asarray(leaf)
            a = a.astype(_carry_dtype(a.dtype))
            a = a.reshape(a.shape[0], size).T
            out.append(jnp.pad(a, ((0, 0), (0, vp - a.shape[1]))))
        return out

    def unrows(self, rows, v):
        leaves = [r[:, :v].T.reshape((v,) + rest).astype(d)
                  for r, d, rest in zip(rows, self.dtypes, self.rests)]
        return self.treedef.unflatten(leaves)

    # -- inside the kernel ---------------------------------------------------

    def load(self, refs, *idx):
        """Flat ``[VB]`` rows of every element (carry dtypes)."""
        return [ref[idx + (j, slice(None))]
                for ref, size in zip(refs, self.sizes) for j in range(size)]

    def store(self, refs, elems, *idx):
        i = 0
        for ref, size in zip(refs, self.sizes):
            for j in range(size):
                ref[idx + (j, slice(None))] = elems[i]
                i += 1

    def build(self, elems):
        """Flat rows -> the pytree the module code sees."""
        out, i = [], 0
        for d, rest, size in zip(self.dtypes, self.rests, self.sizes):
            vals = elems[i:i + size]
            i += size
            if d == jnp.bool_:
                vals = [v != 0 for v in vals]
            out.append(_nest(vals, rest))
        return self.treedef.unflatten(out)

    def elems(self, tree):
        """Module values -> flat ``[VB]`` rows in carry dtypes (a leaf fed
        by an unconnected constant input may collapse to a scalar)."""
        out = []
        for value, d, rest in zip(self.treedef.flatten_up_to(tree),
                                  self.dtypes, self.rests):
            for e in _flat(value, rest):
                out.append(jnp.broadcast_to(e, (VB,))
                           .astype(_carry_dtype(d)))
        return out


def _run(one, count: int, carry, unroll: int):
    """``one(t, carry)`` for t = 0 .. count-1 (``count`` static)."""
    groups, rem = divmod(count, unroll)

    def group(g, c):
        base = g * unroll
        for u in range(unroll):
            c = one(base + u, c)
        return c

    if groups:
        carry = jax.lax.fori_loop(0, groups, group, carry)
    for u in range(rem):
        carry = one(groups * unroll + u, carry)
    return carry


def _run_reverse(one, count: int, carry, unroll: int):
    """``one(t, carry)`` for t = count-1 down to 0."""
    groups, rem = divmod(count, unroll)
    for u in range(rem):
        carry = one(count - 1 - u, carry)

    def group(g, c):
        top = count - rem - 1 - g * unroll
        for u in range(unroll):
            c = one(top - u, c)
        return c

    if groups:
        carry = jax.lax.fori_loop(0, groups, group, carry)
    return carry


def _row_spec(size):
    return pl.BlockSpec((size, VB), lambda i: (0, i))


def _lane_spec(n):
    return pl.BlockSpec((n, VB), lambda i: (0, i))


def _chunked_spec(n_chunks, size):
    return pl.BlockSpec((n_chunks, size, VB), lambda i: (0, 0, i))


def _pallas(kernel, vp, in_specs, out_specs, out_shape, name, interpret):
    return pl.pallas_call(
        kernel,
        grid=(vp // VB,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name=name,
    )


def _forward(step, n, pspec, sspec, lane_keys, out_keys, vp, *, unroll,
             chunk, interpret):
    """The forward ``pallas_call``.  With ``chunk`` it also writes the state
    at every chunk start (the backward's checkpoints)."""
    n_p, n_s, n_x = len(pspec.sizes), len(sspec.sizes), len(lane_keys)
    n_o = len(out_keys)
    n_chunks = -(-n // chunk) if chunk else 0

    def kernel(*refs):
        p_refs, refs = refs[:n_p], refs[n_p:]
        s_refs, refs = refs[:n_s], refs[n_s:]
        x_refs, refs = refs[:n_x], refs[n_x:]
        o_refs, refs = refs[:n_o], refs[n_o:]
        so_refs, b_refs = refs[:n_s], refs[n_s:]
        params = pspec.build(pspec.load(p_refs))

        def sample(t0):
            def one(tl, carry):
                t = t0 + tl
                x_t = {k: r[t, :] for k, r in zip(lane_keys, x_refs)}
                new_state, outs = step(params, sspec.build(list(carry)), x_t)
                for k, r in zip(out_keys, o_refs):
                    r[t, :] = jnp.broadcast_to(outs[k], (VB,)).astype(r.dtype)
                return tuple(sspec.elems(new_state))
            return one

        carry = tuple(sspec.load(s_refs))
        if not chunk:
            carry = _run(sample(0), n, carry, unroll)
        else:
            n_full, rem = divmod(n, chunk)

            def chunk_body(c, carry):
                sspec.store(b_refs, carry, c)
                return _run(sample(c * chunk), chunk, carry, unroll)

            if n_full:
                carry = jax.lax.fori_loop(0, n_full, chunk_body, carry)
            if rem:
                sspec.store(b_refs, carry, n_full)
                carry = _run(sample(n_full * chunk), rem, carry, unroll)
        sspec.store(so_refs, carry)

    s_shapes = [((size, vp), _carry_dtype(d))
                for size, d in zip(sspec.sizes, sspec.dtypes)]
    in_specs = ([_row_spec(s) for s in pspec.sizes]
                + [_row_spec(s) for s in sspec.sizes]
                + [_lane_spec(n)] * n_x)
    out_specs = ([_lane_spec(n)] * n_o
                 + [_row_spec(s) for s in sspec.sizes])
    out_shape = ([jax.ShapeDtypeStruct((n, vp), CV_DTYPE)] * n_o
                 + [jax.ShapeDtypeStruct(s, d) for s, d in s_shapes])
    if chunk:
        out_specs += [_chunked_spec(n_chunks, s) for s in sspec.sizes]
        out_shape += [jax.ShapeDtypeStruct((n_chunks,) + s, d)
                      for s, d in s_shapes]
    return _pallas(kernel, vp, in_specs, out_specs, out_shape,
                   "voice_shell_fwd", interpret)


def _backward(step, n, pspec, sspec, lane_keys, out_keys, vp, *, unroll,
              chunk, interpret):
    """The backward ``pallas_call``: inputs params, chunk checkpoints,
    lanes, output cotangents and final-state cotangents (float leaves);
    outputs float-param cotangents, initial-state cotangents (float
    leaves) and the per-program recompute buffers."""
    n_p, n_s, n_x = len(pspec.sizes), len(sspec.sizes), len(lane_keys)
    n_o = len(out_keys)
    n_chunks = -(-n // chunk)
    pf_leaves = [i for i, d in enumerate(pspec.dtypes) if _is_float(d)]
    sf_leaves = [i for i, d in enumerate(sspec.dtypes) if _is_float(d)]
    pf_pos, sf_pos = pspec.float_pos, sspec.float_pos
    n_sf, n_pf = len(sf_leaves), len(pf_leaves)

    def kernel(*refs):
        p_refs, refs = refs[:n_p], refs[n_p:]
        b_refs, refs = refs[:n_s], refs[n_s:]
        x_refs, refs = refs[:n_x], refs[n_x:]
        cto_refs, refs = refs[:n_o], refs[n_o:]
        ctf_refs, refs = refs[:n_sf], refs[n_sf:]
        gp_refs, refs = refs[:n_pf], refs[n_pf:]
        gs_refs, buf_refs = refs[:n_sf], refs[n_sf:]
        p_elems = pspec.load(p_refs)
        params = pspec.build(p_elems)
        pf0 = [p_elems[i] for i in pf_pos]

        def recompute(t0):
            def one(tl, carry):
                sspec.store(buf_refs, carry, tl)
                x_t = {k: r[t0 + tl, :] for k, r in zip(lane_keys, x_refs)}
                new_state, _ = step(params, sspec.build(list(carry)), x_t)
                return tuple(sspec.elems(new_state))
            return one

        def sweep(t0):
            def one(tl, carry):
                t = t0 + tl
                ct_s, pg = list(carry[:len(sf_pos)]), carry[len(sf_pos):]
                stored = sspec.load(buf_refs, tl)
                x_t = {k: r[t, :] for k, r in zip(lane_keys, x_refs)}
                ct_o = [r[t, :] for r in cto_refs]

                def f(pf, sf):
                    pe = list(p_elems)
                    for i, e in zip(pf_pos, pf):
                        pe[i] = e
                    se = list(stored)
                    for i, e in zip(sf_pos, sf):
                        se[i] = e
                    new_state, outs = step(pspec.build(pe), sspec.build(se),
                                           x_t)
                    ne = sspec.elems(new_state)
                    return ([ne[i] for i in sf_pos],
                            [jnp.broadcast_to(outs[k], (VB,))
                             .astype(CV_DTYPE) for k in out_keys])

                _, vjp = jax.vjp(f, pf0, [stored[i] for i in sf_pos])
                dp, ds = vjp((ct_s, ct_o))
                return tuple(ds) + tuple(a + b for a, b in zip(pg, dp))
            return one

        def do_chunk(c, length, carry):
            t0 = c * chunk
            _run(recompute(t0), length, tuple(sspec.load(b_refs, c)), unroll)
            return _run_reverse(sweep(t0), length, carry, unroll)

        ct_final = [r[j, :] for r, i in zip(ctf_refs, sf_leaves)
                    for j in range(sspec.sizes[i])]
        carry = tuple(ct_final) + tuple(jnp.zeros_like(e) for e in pf0)
        n_full, rem = divmod(n, chunk)
        if rem:
            carry = do_chunk(n_full, rem, carry)
        if n_full:
            carry = jax.lax.fori_loop(
                0, n_full, lambda i, c: do_chunk(n_full - 1 - i, chunk, c),
                carry)
        ct_s, pg = carry[:len(sf_pos)], carry[len(sf_pos):]
        k = 0
        for r, i in zip(gs_refs, sf_leaves):
            for j in range(sspec.sizes[i]):
                r[j, :] = ct_s[k]
                k += 1
        k = 0
        for r, i in zip(gp_refs, pf_leaves):
            for j in range(pspec.sizes[i]):
                r[j, :] = pg[k]
                k += 1

    in_specs = ([_row_spec(s) for s in pspec.sizes]
                + [_chunked_spec(n_chunks, s) for s in sspec.sizes]
                + [_lane_spec(n)] * (n_x + n_o)
                + [_row_spec(sspec.sizes[i]) for i in sf_leaves])
    out_specs = ([_row_spec(pspec.sizes[i]) for i in pf_leaves]
                 + [_row_spec(sspec.sizes[i]) for i in sf_leaves]
                 + [_chunked_spec(chunk, s) for s in sspec.sizes])
    out_shape = (
        [jax.ShapeDtypeStruct((pspec.sizes[i], vp), pspec.dtypes[i])
         for i in pf_leaves]
        + [jax.ShapeDtypeStruct((sspec.sizes[i], vp), sspec.dtypes[i])
           for i in sf_leaves]
        + [jax.ShapeDtypeStruct((chunk, s, vp), _carry_dtype(d))
           for s, d in zip(sspec.sizes, sspec.dtypes)])
    return _pallas(kernel, vp, in_specs, out_specs, out_shape,
                   "voice_shell_bwd", interpret)


def _lane_rows(lanes, keys, vp):
    """{key: [V, n]} -> time-major ``[n, Vp]`` rows, in ``keys`` order."""
    out = []
    for k in keys:
        a = jnp.asarray(lanes[k], CV_DTYPE).T
        out.append(jnp.pad(a, ((0, 0), (0, vp - a.shape[1]))))
    return out


def _voices(*trees) -> int:
    return jax.tree.leaves(trees)[0].shape[0]


def run(step, n: int, params, state, lanes, out_keys, *, unroll: int = 8,
        interpret: bool = False):
    """Run ``step`` over ``n`` samples for every voice.

    ``params`` / ``state``: pytrees with a leading voice axis on every leaf;
    ``lanes``: {key: [V, n]} per-sample inputs.  Returns
    ``(outs {key: [V, n]}, final_state)``.
    """
    v = _voices(params, state, lanes)
    vp = padded_voices(v)
    pspec, sspec = _Spec(params), _Spec(state)
    lane_keys, out_keys = sorted(lanes), list(out_keys)
    res = _forward(step, n, pspec, sspec, lane_keys, out_keys, vp,
                   unroll=unroll, chunk=None, interpret=interpret)(
        *pspec.rows(params, vp), *sspec.rows(state, vp),
        *_lane_rows(lanes, lane_keys, vp))
    outs = {k: r[:, :v].T for k, r in zip(out_keys, res)}
    return outs, sspec.unrows(res[len(out_keys):], v)


def _zero_ct(x):
    """Zero cotangent: float0 for integer/bool primals, zeros for floats."""
    if _is_float(jnp.asarray(x).dtype):
        return jnp.zeros_like(x)
    return np.zeros(jnp.shape(x), jax_dtypes.float0)


def differentiable(step, n: int, out_keys, *, unroll: int = 4,
                   chunk: int = CHUNK, interpret: bool = False):
    """:func:`run` as ``fn(params, state, lanes) -> (outs, final_state)``
    with the shell's backward kernel as its VJP: cotangents flow to float
    params and float initial-state leaves."""
    out_keys = list(out_keys)
    chunk = min(chunk, n)

    def forward(params, state, lanes, with_checkpoints):
        v = _voices(params, state, lanes)
        vp = padded_voices(v)
        pspec, sspec = _Spec(params), _Spec(state)
        lane_keys = sorted(lanes)
        res = _forward(step, n, pspec, sspec, lane_keys, out_keys, vp,
                       unroll=unroll,
                       chunk=chunk if with_checkpoints else None,
                       interpret=interpret)(
            *pspec.rows(params, vp), *sspec.rows(state, vp),
            *_lane_rows(lanes, lane_keys, vp))
        n_o, n_s = len(out_keys), len(sspec.sizes)
        outs = {k: r[:, :v].T for k, r in zip(out_keys, res)}
        final = sspec.unrows(res[n_o:n_o + n_s], v)
        return outs, final, res[n_o + n_s:]

    @jax.custom_vjp
    def fn(params, state, lanes):
        outs, final, _ = forward(params, state, lanes, False)
        return outs, final

    def fn_fwd(params, state, lanes):
        outs, final, checkpoints = forward(params, state, lanes, True)
        return (outs, final), (params, state, lanes, checkpoints)

    def fn_bwd(res, ct):
        params, state, lanes, checkpoints = res
        ct_outs, ct_final = ct
        v = _voices(params, state, lanes)
        vp = padded_voices(v)
        pspec, sspec = _Spec(params), _Spec(state)
        lane_keys = sorted(lanes)
        ctf_leaves = jax.tree.leaves(ct_final)
        sf_leaves = [i for i, d in enumerate(sspec.dtypes) if _is_float(d)]
        pf_leaves = [i for i, d in enumerate(pspec.dtypes) if _is_float(d)]
        ctf_rows = [
            jnp.pad(jnp.asarray(ctf_leaves[i], sspec.dtypes[i])
                    .reshape(v, sspec.sizes[i]).T, ((0, 0), (0, vp - v)))
            for i in sf_leaves]
        # a non-finite output cotangent (e.g. from a loss on a clipped
        # voice) would poison every earlier sample of the reverse sweep
        ct_rows = [jnp.nan_to_num(r) for r in
                   _lane_rows(ct_outs, out_keys, vp)]
        res_b = _backward(step, n, pspec, sspec, lane_keys, out_keys, vp,
                          unroll=unroll, chunk=chunk, interpret=interpret)(
            *pspec.rows(params, vp), *checkpoints,
            *_lane_rows(lanes, lane_keys, vp), *ct_rows, *ctf_rows)
        gp, gs = res_b[:len(pf_leaves)], res_b[len(pf_leaves):
                                                len(pf_leaves) + len(sf_leaves)]

        def grads(spec, tree, float_leaves, rows):
            leaves = [_zero_ct(l) for l in jax.tree.leaves(tree)]
            for i, r in zip(float_leaves, rows):
                leaves[i] = (r[:, :v].T.reshape((v,) + spec.rests[i])
                             .astype(spec.dtypes[i]))
            return spec.treedef.unflatten(leaves)

        return (grads(pspec, params, pf_leaves, gp),
                grads(sspec, state, sf_leaves, gs),
                jax.tree.map(_zero_ct, lanes))

    fn.defvjp(fn_fwd, fn_bwd)
    return fn
