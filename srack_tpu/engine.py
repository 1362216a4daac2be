"""Render entry points.

These replace the reference's cpal real-time layer (src/main.rs:24-101): the
audio callback's execute-then-interleave machinery becomes pure functions
returning ``[channels, n]`` arrays, a block-iterator for streaming, and a
batched render farm.

* :func:`render` -- offline render of a patch.
* :func:`render_stream` -- generator of ``block_size`` chunks carrying
  module state between blocks, the analogue of the reference's
  buffer-to-buffer streaming (main.rs:59-90); O(1) memory for unbounded
  renders.
* :func:`render_batch` -- vmap over stacked parameter pytrees: thousands of
  voices/patches of one topology rendered in parallel (SURVEY.md §2f).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import jax
import jax.numpy as jnp

from .compiler import compile_patch, migrate_state
from .patch import Patch


def render(patch: Patch, n_samples: int, *, params: Optional[dict] = None,
           state: Optional[dict] = None, key=None, drivers=None,
           automation: Optional[dict] = None,
           probes: Sequence = (), engine: str = "auto",
           segment: Optional[int] = None):
    """Render ``n_samples`` of a patch offline.

    Returns ``(audio, probes, final_state)``; ``audio`` is ``[channels, n]``
    float32.  Mirrors "run the graph for n/block ticks and keep the Output
    module's buffers" in the reference.

    ``automation``: ``{(module, "param"): [n] array}`` -- per-sample
    automation lanes for any scalar module param (the DAW-style layer the
    reference's static sliders lack); exact per-sample semantics on the
    scan and fused engines.

    ``segment``: render in ``segment``-sample pieces on device (one
    dispatch, ``lax.scan`` with carried state) -- bounds live intermediates
    for render lengths that OOM unsegmented; same semantics as
    :func:`render_long` without the per-segment host round trip.
    """
    compiled = compile_patch(patch, probes=probes,
                             automation=tuple(automation or ()))
    return compiled.render(n_samples, params=params, state=state, key=key,
                           drivers=drivers, automation=automation,
                           engine=engine, segment=segment)


def render_stream(patch: Patch, *, params: Optional[dict] = None,
                  state: Optional[dict] = None, key=None,
                  n_blocks: Optional[int] = None,
                  automation: Optional[dict] = None,
                  probes: Sequence = (), voices: Optional[int] = None,
                  engine: str = "auto") -> Iterator:
    """Yield ``(audio_block, probe_block, state)`` tuples of
    ``block_size`` samples forever (or for ``n_blocks``).

    ``automation`` lanes are consumed block-by-block; a stream that
    outlives its lanes holds each lane's final value (like a DAW past the
    end of an automation clip).

    **Batched streaming**: pass ``voices=V`` (and optionally stacked
    ``params`` with a leading ``V`` axis, see :func:`stack_params` /
    :func:`replicate_params`) to stream ``V`` voices of the topology at
    once -- audio blocks are ``[V, channels, block]`` and run on the
    batch engines (voice-kernel shell / block engine), so the
    reference's play-while-editing loop works at the 1000-voice scale
    that justifies the batch engines, not just one voice at a time.
    Live topology edits migrate every voice's state across the swap.

    **Live patching**: the stream re-reads ``patch`` every block, exactly
    as the reference's audio callback picks up the UI thread's re-plan at
    its next ``plan.lock()`` (src/ui.rs:63-82, src/main.rs:60).  Mutating
    the patch between blocks -- adding/deleting modules, rewiring,
    moving sliders -- takes effect on the next block; surviving modules
    keep their phase/envelope/delay-line state across the swap
    (:func:`srack_tpu.compiler.migrate_state`), matching the reference's
    long-lived module objects (oscillator.rs:151-152).  Explicit ``params``
    pin parameter values (topology edits still apply); with the default
    ``params=None``, slider edits via ``patch.set_params`` go live on the
    next block, like the reference's per-tick param reads (batched
    streams replicate the patch's params across voices each block)."""
    compiled = compile_patch(patch, probes=probes,
                             automation=tuple(automation or ()))
    cfg = compiled.cfg
    block = cfg.block_size
    batched = voices is not None
    pinned_params = params is not None
    if batched:
        if params is not None:
            v_have = jax.tree.leaves(params)[0].shape[0]
            if v_have != voices:
                raise ValueError(
                    f"params carry {v_have} voices, stream asked for "
                    f"{voices}")
        else:
            params = replicate_params(compiled.default_params, voices)
    elif params is None:
        params = compiled.default_params
    if state is None:
        state = compiled.init_state()
        if batched:
            state = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (voices,) + a.shape), state)
    if key is None:
        key = jax.random.PRNGKey(0)
    elif isinstance(key, int):
        key = jax.random.PRNGKey(key)

    def lane_block(arr, start, block):
        # ``start`` is the stream's consumed-sample cursor, NOT i * block:
        # a live ``set_audio_config`` block-size change mid-stream must
        # continue the lanes where they left off, not replay/skip samples.
        arr = jnp.asarray(arr)
        if start + block <= arr.shape[-1]:
            return arr[..., start:start + block]
        tail = arr[..., start:] if start < arr.shape[-1] else arr[..., -1:]
        pad = block - tail.shape[-1]
        hold = jnp.broadcast_to(arr[..., -1:], arr.shape[:-1] + (pad,))
        return jnp.concatenate([tail, hold], axis=-1)

    i = 0
    consumed = 0
    while n_blocks is None or i < n_blocks:
        if patch.topology_key() != compiled.topology_key:
            # live topology edit: re-plan (compile cache keyed by topology)
            # and migrate state, the reference's mutex plan swap
            new_compiled = compile_patch(patch, probes=probes,
                                         automation=tuple(automation or ()))
            state = migrate_state(compiled, new_compiled, state)
            compiled = new_compiled
            block = compiled.cfg.block_size
            defaults = (replicate_params(compiled.default_params, voices)
                        if batched else compiled.default_params)
            if not pinned_params:
                params = defaults
            else:
                # pinned params follow the edit: surviving modules keep
                # their pinned values, modules the edit added start from
                # the patch's defaults, deleted ones drop out
                params = {mid: params.get(mid, defaults[mid])
                          for mid in defaults}
        elif not pinned_params:
            # live slider edits, no recompile
            live = patch.params()
            params = replicate_params(live, voices) if batched else live
        key, sub = jax.random.split(key)
        autos_b = ({k: lane_block(v, consumed, block)
                    for k, v in automation.items()}
                   if automation else None)
        audio, probe_vals, state = compiled.render(
            block, params=params, state=state, key=sub,
            automation=autos_b, batched=batched, engine=engine)
        yield audio, probe_vals, state
        consumed += block
        i += 1


def stack_params(param_list: Sequence[dict]) -> dict:
    """Stack per-voice param pytrees (same topology) along a leading axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *param_list)


def replicate_params(params: dict, n: int) -> dict:
    """Broadcast one param pytree to ``n`` identical voices."""
    return jax.tree.map(
        lambda a: jnp.broadcast_to(a, (n,) + a.shape), params)


def render_long(patch: Patch, n_samples: int, *,
                segment: int = 48000 * 20, params: Optional[dict] = None,
                state: Optional[dict] = None, key=None, batched: bool = False,
                automation: Optional[dict] = None, out=None,
                engine: str = "auto"):
    """Render arbitrarily long audio in fixed segments with carried state.

    A single device call must hold its whole output in HBM; this loops
    ``render`` over ``segment``-sample pieces (one compile, reused), carries
    module state between them -- bit-identical to one long render in fast
    mode (int32 phase accumulators are associativity-free) -- and assembles
    into a host numpy array (or a preallocated ``out``).  O(segment) device
    memory for unbounded n (SURVEY.md §5 long-context).
    """
    import numpy as np

    compiled = compile_patch(patch, automation=tuple(automation or ()))
    if automation:
        for (_, _), arr in automation.items():
            if jnp.shape(arr)[-1] != n_samples:
                raise ValueError(
                    "render_long automation lanes must cover the whole "
                    f"render: lane has {jnp.shape(arr)[-1]} samples, "
                    f"n_samples={n_samples}")
    if params is None:
        params = compiled.default_params
    if state is None:
        state = compiled.init_state()
        if batched:
            v = jax.tree.leaves(params)[0].shape[0]
            state = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (v,) + a.shape), state)
    if key is None:
        key = jax.random.PRNGKey(0)
    elif isinstance(key, int):
        key = jax.random.PRNGKey(key)

    done = 0
    seg_idx = 0
    while done < n_samples:
        m = min(segment, n_samples - done)
        # fresh noise lanes per segment (noise is keyed randomness; the
        # deterministic state carry is what must -- and does -- line up)
        if key.ndim == 2:
            key_arg = jax.vmap(lambda k: jax.random.fold_in(k, seg_idx))(key)
        else:
            key_arg = jax.random.fold_in(key, seg_idx)
        seg_idx += 1
        autos_seg = ({k: jnp.asarray(v)[..., done:done + m]
                      for k, v in automation.items()}
                     if automation else None)
        audio, _, state = compiled.render(m, params=params, state=state,
                                          key=key_arg, batched=batched,
                                          automation=autos_seg, engine=engine)
        a = np.asarray(audio)
        if out is None:
            shape = a.shape[:-1] + (n_samples,)
            out = np.zeros(shape, dtype=a.dtype)
        out[..., done:done + m] = a
        done += m
    return out, state


def render_many(patches: Sequence[Patch], n_samples: int, *, key=None,
                mesh=None):
    """Render many patches of possibly *different* topologies.

    Patches are grouped by compiled topology (same program => one vmapped
    batch, SURVEY.md §7 step 6); each group renders in a single batched
    call.  Returns a list of ``[channels, n]`` arrays in input order.

    With ``mesh``, topology groups are placed on the mesh's devices by a
    greedy longest-processing-time schedule -- groups sorted by estimated
    cost (voices x module count, the dominant term for the per-sample
    engines) and assigned to the least-loaded device -- so heterogeneous
    groups balance across chips; dispatch is async, so they execute
    concurrently instead of serializing on one.
    """
    groups: dict = {}
    for i, p in enumerate(patches):
        groups.setdefault(p.topology_key(), []).append(i)
    results: list = [None] * len(patches)
    if key is None:
        key = jax.random.PRNGKey(0)
    elif isinstance(key, int):
        key = jax.random.PRNGKey(key)
    devices = list(mesh.devices.flat) if mesh is not None else None
    group_list = list(enumerate(groups.values()))
    assignment = {}
    if devices is not None:
        load = [0.0] * len(devices)
        costed = sorted(
            group_list,
            key=lambda g: -(len(g[1]) * len(patches[g[1][0]])))
        for gi, idxs in costed:
            d = min(range(len(devices)), key=load.__getitem__)
            assignment[gi] = d
            load[d] += len(idxs) * len(patches[idxs[0]])
    for gi, idxs in group_list:
        sub = jax.random.fold_in(key, gi)

        def place(tree):
            if devices is None:
                return tree
            dev = devices[assignment[gi]]
            return jax.tree.map(lambda a: jax.device_put(a, dev), tree)

        if len(idxs) == 1:
            i = idxs[0]
            audio, _, _ = render(patches[i], n_samples, key=sub,
                                 params=place(patches[i].params()))
            results[i] = audio
        else:
            stacked = place(stack_params([patches[i].params()
                                          for i in idxs]))
            audio, _, _ = render_batch(patches[idxs[0]], n_samples,
                                       params=stacked, key=sub)
            for j, i in enumerate(idxs):
                results[i] = audio[j]
    return results


def render_batch(patch: Patch, n_samples: int, *, params: dict,
                 state: Optional[dict] = None, key=None, drivers=None,
                 automation: Optional[dict] = None, probes: Sequence = (),
                 engine: str = "auto", segment: Optional[int] = None):
    """Render a batch of voices of one topology in parallel.

    ``params`` must carry a leading voice axis on every leaf (see
    :func:`stack_params` / :func:`replicate_params`).  Returns audio of
    shape ``[voices, channels, n]``.  This is the batched replacement for
    instantiating N module graphs (SURVEY.md §2f: voice batching).
    ``automation`` lanes may be shared ``[n]`` (broadcast over voices) or
    per-voice ``[V, n]``.
    """
    compiled = compile_patch(patch, probes=probes,
                             automation=tuple(automation or ()))
    return compiled.render(n_samples, params=params, state=state, key=key,
                           drivers=drivers, automation=automation,
                           batched=True, engine=engine, segment=segment)
