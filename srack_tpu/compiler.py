"""Patch compiler: lower a Patch IR to one fused JAX program.

The reference's hot loop is two nested loops -- a sequential module loop per
tick (src/synth.rs:97-101) around per-sample loops inside each ``calc()``
(src/main.rs:59-90 call stack).  Lowering inverts that nesting, which is the
whole accelerator trick: the module chain becomes straight-line code
*inside* a single per-sample loop body, so every module's math fuses into
one loop body with all state in registers, and ``vmap`` turns the body
into wide lanes across voices.

Feedback semantics: the planner deletes back-edges (synth.rs:168-192) and
the Rust runtime then simply reads whatever is in the source's buffer --
fresh if the source already ran this tick, else the previous tick's value.
The compiler reproduces that rule purely from plan positions: an input whose
source is planned at-or-after its sink reads the scan carry ("fb") instead
of this sample's value.

* default (``buffer_feedback=False``): fb holds the previous *sample*
  (one-sample feedback delay -- tighter than the reference can do).
* compat (``buffer_feedback=True``): fb holds the previous *block* of
  ``block_size`` samples, reproducing the reference's previous-buffer
  semantics exactly; rendering runs as an outer scan over blocks whose
  inner scan consumes the previous block's fb lanes as xs.

Stateless per-sample sources (Noise randomness, Input drivers) are hoisted
out of the scan as xs with leading time axis.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from .config import AudioConfig
from .modules.base import CV_DTYPE
from .patch import Patch, ModuleHandle
from .planner import plan_execution


def _probe_key(mid: str, port: int) -> str:
    return f"{mid}:{port}"


class _LRU(OrderedDict):
    """Bounded insertion/access-ordered cache.

    Long-lived processes (the render-service example serves arbitrary
    topologies and render lengths) would otherwise accumulate compiled
    executables without bound -- each holds JIT code pages, and one process
    segfaults inside LLVM around ~65k mappings (vm.max_map_count; see
    CLAUDE.md).  Evicted entries drop their reference; XLA frees the
    executable when the jitted wrapper is garbage-collected.
    """

    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap

    def get(self, key, default=None):
        v = super().get(key, default)
        if key in self:
            self.move_to_end(key)
        return v

    def put(self, key, value) -> None:
        self[key] = value
        self.move_to_end(key)
        while len(self) > self.cap:
            self.popitem(last=False)


# Per-patch cap on cached jitted render fns (distinct (n, batched, engine,
# segment) combinations) and global cap on compiled topologies.
FN_CACHE_CAP = 32
COMPILE_CACHE_CAP = 64


class CompiledPatch:
    """An executable patch: static structure + cached jitted render fns."""

    def __init__(self, patch: Patch, probes: Sequence = (),
                 automation: Sequence = ()):
        self.cfg: AudioConfig = patch.config
        self.plan, self.broken = plan_execution(patch)
        self.plan_pos = {mid: i for i, mid in enumerate(self.plan)}
        self.output_id = patch.output.id
        # Snapshot static structure (the Patch may mutate afterwards).
        self.instances = {
            inst.id: (inst.mdef, inst.statics, tuple(inst.inputs))
            for inst in patch
        }
        self.default_params = patch.params()
        self.topology_key = patch.topology_key()

        # probes: (module, port) pairs resolved to (mid, port_idx)
        self.probes = []
        for module, port in probes:
            mid = module.id if isinstance(module, ModuleHandle) else module
            mdef, statics, _ = self.instances[mid]
            pidx = mdef.port_index(self.cfg, statics, port, output=True)
            self.probes.append((mid, pidx))

        # feedback reads: inputs whose source runs at-or-after the sink
        self.fb_keys = set()
        for mid, (_, _, inputs) in self.instances.items():
            for conn in inputs:
                if conn is None:
                    continue
                src, sport = conn
                if self.plan_pos[src] >= self.plan_pos[mid]:
                    self.fb_keys.add((src, sport))
        self.fb_keys = tuple(sorted(self.fb_keys))

        # modules with hoisted per-sample inputs (noise xs / Input drivers)
        self.xs_modules = tuple(
            mid for mid in self.plan
            if self.instances[mid][0].make_xs is not None
            or self.instances[mid][0].type_name == "Input"
        )

        # automation lanes: (module, param) pairs promoted from per-render
        # constants to per-sample xs (the reference has no analogue -- its
        # sliders are static between UI events, ui.rs:243+; this is the
        # engine-level "parameter automation" a DAW layers on top).  The
        # overlay happens in _sample_step, so the scan and fused engines get
        # exact per-sample semantics; the block engine streams lanes into
        # its serial stage (exact) or overlays [n]-lane params on block
        # impls that declare support (ModuleDef.auto_block_params).
        autos = []
        for module, pname in automation:
            mid = module.id if isinstance(module, ModuleHandle) else module
            if mid not in self.instances:
                raise KeyError(f"automation target {mid!r} not in patch")
            leaf = self.default_params[mid].get(pname)
            if leaf is None:
                raise KeyError(
                    f"{mid!r} has no param {pname!r} "
                    f"(has: {sorted(self.default_params[mid])})")
            if getattr(leaf, "ndim", 0) != 0:
                raise ValueError(
                    f"only scalar params can be automated; {mid}.{pname} "
                    f"has shape {leaf.shape}")
            autos.append((mid, pname))
        self.automation = tuple(sorted(set(autos)))
        self._auto_by_mid: dict = {}
        for mid, pname in self.automation:
            self._auto_by_mid.setdefault(mid, []).append(pname)
        self._fn_cache = _LRU(FN_CACHE_CAP)

    @staticmethod
    def _auto_key(mid: str, pname: str) -> str:
        return f"{mid}~{pname}"

    # -- state --------------------------------------------------------------

    def init_state(self) -> dict:
        cfg = self.cfg
        states = {
            mid: mdef.init_state(cfg, statics)
            for mid, (mdef, statics, _) in self.instances.items()
        }
        if cfg.buffer_feedback:
            fb = {k: jnp.zeros((cfg.block_size,), dtype=CV_DTYPE)
                  for k in self.fb_keys}
        else:
            fb = {k: jnp.zeros((), dtype=CV_DTYPE) for k in self.fb_keys}
        return {"states": states, "fb": fb}

    def derived_params(self, params: dict) -> dict:
        """Merge each module's per-render derived params (ModuleDef.derive).

        Applied once per render call, outside the per-sample loop, so
        reciprocals/filter coefficients are not recomputed per sample
        whatever the kernel compiler would hoist.  Pure jnp,
        differentiable, broadcasts over batched leaves.
        """
        out = {}
        for mid, (mdef, statics, inputs) in self.instances.items():
            pd = params[mid]
            # automated modules skip derive: a hoisted value computed from
            # the (overridden) static param would be stale; their steps fall
            # back to the in-loop computation
            if mdef.derive is not None and mid not in self._auto_by_mid:
                connected = tuple(c is not None for c in inputs)
                pd = {**pd, **mdef.derive(self.cfg, statics, pd, connected)}
            out[mid] = pd
        return out

    # -- xs (hoisted per-sample inputs) --------------------------------------

    def _make_xs(self, params: dict, key, n: int, drivers: dict) -> dict:
        xs = {}
        for i, mid in enumerate(self.xs_modules):
            mdef, statics, _ = self.instances[mid]
            if mid in drivers:
                arr = jnp.asarray(drivers[mid], dtype=CV_DTYPE)
                if arr.shape[-1] != n:
                    raise ValueError(
                        f"driver for {mid} has {arr.shape[-1]} samples, "
                        f"render needs {n}")
                xs[mid] = arr
            elif mdef.make_xs is not None:
                sub = jax.random.fold_in(key, i)
                xs[mid] = mdef.make_xs(self.cfg, statics, params[mid], sub, n)
            # Input modules without a driver: step() falls back to the
            # constant param; no xs entry.
        for mid, pname in self.automation:
            k = self._auto_key(mid, pname)
            arr = drivers.get(k)
            if arr is None:
                # no lane this render: hold the static param value
                arr = jnp.broadcast_to(params[mid][pname], (n,))
            else:
                arr = jnp.asarray(arr, dtype=CV_DTYPE)
                if arr.shape[-1] != n:
                    raise ValueError(
                        f"automation lane {mid}.{pname} has {arr.shape[-1]} "
                        f"samples, render needs {n}")
            xs[k] = arr.astype(CV_DTYPE)
        return xs

    # -- the fused per-sample body -------------------------------------------

    def _sample_step(self, params, states, fb_t, x_t, nograd: bool = False):
        """One sample through the whole plan.  ``fb_t`` maps fb key ->
        scalar feedback value for this sample; ``x_t`` maps module id ->
        this sample's hoisted input.  Returns ``(new_states, fb_out,
        channels, probes)`` with one value per output channel (the
        voice-kernel shell stores channels one by one: it cannot stack).
        ``nograd=True`` (only legal from engines that are never
        differentiated, e.g. the plain fused render) lets modules elide
        gradient-only ops via ``ModuleDef.step_nograd``; primal outputs are
        bit-identical."""
        cfg = self.cfg
        values = {}
        new_states = {}
        channels = None
        for mid in self.plan:
            mdef, statics, inputs = self.instances[mid]
            ins = []
            for conn in inputs:
                if conn is None:
                    ins.append(None)
                else:
                    src, sport = conn
                    if self.plan_pos[src] >= self.plan_pos[mid]:
                        ins.append(fb_t[(src, sport)])
                    else:
                        ins.append(values[(src, sport)])
            pd = params[mid]
            auto = self._auto_by_mid.get(mid)
            if auto:
                # per-sample automation overlay: the step sees this sample's
                # lane value where the static param would be
                pd = {**pd, **{p: x_t[self._auto_key(mid, p)] for p in auto}}
            step = (mdef.step_nograd
                    if nograd and mdef.step_nograd is not None else mdef.step)
            with jax.named_scope(f"{mdef.type_name}:{mid}"):
                new_state, outs = step(
                    cfg, statics, pd, states[mid], ins,
                    x_t.get(mid))
            new_states[mid] = new_state
            for p, v in enumerate(outs):
                values[(mid, p)] = v
            if mid == self.output_id:
                channels = outs
        fb_out = {k: values[k] for k in self.fb_keys}
        probe_vals = {
            _probe_key(mid, p): values[(mid, p)] for mid, p in self.probes}
        return new_states, fb_out, tuple(channels or ()), probe_vals

    # -- whole-render programs ----------------------------------------------

    @staticmethod
    def _stack_channels(channels):
        if not channels:
            return jnp.zeros((0,), CV_DTYPE)
        # an unconnected output channel is a scalar 0: broadcast to the
        # connected channels' shape before stacking
        target = jnp.broadcast_shapes(*(jnp.shape(c) for c in channels))
        return jnp.stack([jnp.broadcast_to(c, target) for c in channels])

    def _render_sample_mode(self, params, state, xs, n: int):
        def body(carry, x_t):
            states, fb = carry
            new_states, fb_out, channels, probe_vals = self._sample_step(
                params, states, fb, x_t)
            return (new_states, fb_out), (self._stack_channels(channels),
                                          probe_vals)

        (states_f, fb_f), (ys, probe_ys) = jax.lax.scan(
            body, (state["states"], state["fb"]), xs, length=n)
        audio = jnp.transpose(ys)  # [n, C] -> [C, n]
        return audio, probe_ys, {"states": states_f, "fb": fb_f}

    def _render_buffer_mode(self, params, state, xs, n: int):
        block = self.cfg.block_size
        if n % block != 0:
            raise ValueError(
                f"buffer_feedback mode renders whole blocks: n={n} is not a "
                f"multiple of block_size={block}")
        n_blocks = n // block
        xs_blocked = jax.tree.map(
            lambda a: a.reshape((n_blocks, block) + a.shape[1:]), xs)

        def outer(carry, xs_b):
            states, fb_blocks = carry

            def inner(states2, t_in):
                x_t, fb_t = t_in
                new_states, fb_out, channels, probe_vals = self._sample_step(
                    params, states2, fb_t, x_t)
                return new_states, (self._stack_channels(channels), fb_out,
                                    probe_vals)

            states_f, (audio_b, fb_ys, probe_b) = jax.lax.scan(
                inner, states, (xs_b, fb_blocks), length=block)
            return (states_f, fb_ys), (audio_b, probe_b)

        (states_f, fb_f), (ys, probe_ys) = jax.lax.scan(
            outer, (state["states"], state["fb"]), xs_blocked, length=n_blocks)
        # ys: [n_blocks, block, C] -> [C, n]
        audio = jnp.transpose(ys.reshape((n, -1)))
        probe_ys = jax.tree.map(lambda a: a.reshape((n,) + a.shape[2:]), probe_ys)
        return audio, probe_ys, {"states": states_f, "fb": fb_f}

    # -- public entry --------------------------------------------------------

    def make_render_fn(self, n: int, batched: bool = False):
        """The pure (unjitted) render program:
        ``(params, state, key, drivers) -> (audio, probes, final_state)``."""

        def run(params, state, key, drivers):
            xs = self._make_xs(params, key, n, drivers)
            params = self.derived_params(params)
            if self.cfg.buffer_feedback:
                return self._render_buffer_mode(params, state, xs, n)
            return self._render_sample_mode(params, state, xs, n)

        if batched:
            run = jax.vmap(run, in_axes=(0, 0, 0, 0))
        return run

    def fused_eligible(self) -> bool:
        """True when the patch can run in the voice-kernel shell."""
        from .ops import fused
        return fused.eligible(self)

    def auto_engine(self, batched: bool) -> str:
        """The engine a render takes by default: the shell's whole-patch
        render where the platform has it (route.voice_kernel), else the
        block engine for batches (and for one voice where the shell runs
        its serial stage), else the scan."""
        from . import route
        if batched and self.fused_eligible() and route.voice_kernel():
            return "fused"
        if batched or route.voice_kernel():
            # one voice still takes a block of the shell: the block engine
            # beats a per-sample XLA loop there
            return "block"
        return "scan"

    def block_program(self):
        from . import block_engine
        if getattr(self, "_block_prog", None) is None:
            self._block_prog = block_engine.BlockProgram(self)
        return self._block_prog

    def _build_fn(self, n: int, batched: bool, engine: str):
        """The unjitted ``(params, state, key, drivers) -> (audio, probes,
        final_state)`` program for one engine at one render length."""
        if engine == "fused":
            from . import route
            from .ops import fused
            if not batched:
                raise ValueError("fused engine requires batched render")
            if not fused.eligible(self):
                raise ValueError(
                    "patch not eligible for the fused kernel (needs fast "
                    "precision, no probes, and only register-friendly "
                    f"modules: {sorted(fused.REGISTER_TYPES)} or custom "
                    "types registered with register_safe=True)")
            route.require_voice_kernel("engine='fused'")
            if self.cfg.buffer_feedback:
                return fused.make_fused_render_buffer(self, n)
            return fused.make_fused_render(self, n)
        if engine == "block":
            run_b = self.block_program().make_run(n)
            if batched:
                return run_b

            def run_1(params, state, key, drivers):
                ex = lambda t: jax.tree.map(lambda a: a[None], t)
                audio, probes, final = run_b(
                    ex(params), ex(state), key[None], ex(drivers))
                return (audio[0], probes,
                        jax.tree.map(lambda a: a[0], final))
            return run_1
        return self.make_render_fn(n, batched)

    def _make_segmented(self, n: int, batched: bool, engine: str,
                        segment: int):
        """Device-side segmented render: one dispatch, ``lax.scan`` over
        ``n // segment`` segments with module state carried between them.

        A single unsegmented call must hold every whole-render intermediate
        lane in device memory at once (the block engine's [V, n] wires);
        segmenting bounds live intermediates to one segment while still
        paying one dispatch.
        Semantics are exactly :func:`srack_tpu.engine.render_long`'s -- state
        carries (bit-identical in fast mode), noise lanes re-key per segment
        via ``fold_in(key, seg_idx)`` -- but the loop runs on device instead
        of round-tripping every segment through the host.
        """
        if segment <= 0:
            raise ValueError(f"segment must be positive, got {segment}")
        if n % segment != 0:
            raise ValueError(
                f"segment={segment} must divide the render length n={n}")
        n_seg = n // segment
        inner = self._build_fn(segment, batched, engine)

        def run(params, state, keys, drivers):
            def blocked(a):  # [..., n] -> [n_seg, ..., segment]
                a = jnp.asarray(a)
                a = a.reshape(a.shape[:-1] + (n_seg, segment))
                return jnp.moveaxis(a, -2, 0)

            drv_b = {k: blocked(v) for k, v in (drivers or {}).items()}
            drv0 = {k: v[0] for k, v in drv_b.items()}

            # segments write into carried whole-render buffers via
            # dynamic_update_slice (XLA updates a unique-owned scan carry in
            # place): a stacked [n_seg, ..., segment] scan output plus its
            # untiling transpose would hold TWO whole-render copies live --
            # measured 16.49G > 15.75G HBM on a 30 s x 1024-voice render
            # that fits fine with one
            aud_s, probes_s, _ = jax.eval_shape(
                inner, params, state, keys, drv0)

            def whole(sd):
                return jnp.zeros(sd.shape[:-1] + (n,), sd.dtype)

            bufs0 = (whole(aud_s), jax.tree.map(whole, probes_s))

            def body(carry, drv_i):
                st, i, abuf, pbufs = carry
                # render_long's per-segment noise re-key (engine.py): the
                # deterministic state carry is what must -- and does --
                # line up
                if batched and keys.ndim == 2:
                    k_i = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
                else:
                    k_i = jax.random.fold_in(keys, i)
                audio, probes, st2 = inner(params, st, k_i, drv_i)
                start = i * segment
                abuf = jax.lax.dynamic_update_slice_in_dim(
                    abuf, audio, start, axis=-1)
                pbufs = jax.tree.map(
                    lambda b, v: jax.lax.dynamic_update_slice_in_dim(
                        b, v, start, axis=-1), pbufs, probes)
                return (st2, i + 1, abuf, pbufs), None

            (state_f, _, abuf, pbufs), _ = jax.lax.scan(
                body, (state, jnp.int32(0)) + bufs0, drv_b, length=n_seg)
            return abuf, pbufs, state_f

        return run

    def _get_fn(self, n: int, batched: bool, engine: str = "scan",
                segment: Optional[int] = None):
        cache_key = (n, batched, engine, segment)
        fn = self._fn_cache.get(cache_key)
        if fn is None:
            if segment is not None:
                # segment == n runs a one-iteration segmented scan rather
                # than the plain program: it keeps render_long's
                # per-segment fold_in(key, 0) re-key, so render(n,
                # segment=s) agrees with render_long(n, segment=s) for
                # every valid s (including s == n) on noise patches
                fn = jax.jit(self._make_segmented(n, batched, engine,
                                                  segment))
            else:
                fn = jax.jit(self._build_fn(n, batched, engine))
            self._fn_cache.put(cache_key, fn)
        return fn

    def grad_render_fn(self, n: int, batched: bool = True):
        """A differentiable batched render at kernel speed.

        ``jax.grad`` cannot flow through a Pallas kernel directly.  For
        fused-eligible patches on a platform with the voice-kernel shell
        this returns the shell's forward+backward render (ops/fused_vjp.py).
        Otherwise it wraps the plain program in a ``custom_vjp`` whose
        backward differentiates the scan-engine program.  Signature:
        ``(params, state, keys, drivers) -> (audio, probes, final_state)``.
        """
        from . import route
        if (batched and self.fused_eligible()
                and not self.cfg.buffer_feedback and route.voice_kernel()):
            from .ops import fused_vjp
            return fused_vjp.make_fused_vjp(self, n)
        scan_fn = self.make_render_fn(n, batched=batched)
        fast_fn = scan_fn

        @jax.custom_vjp
        def render(params, state, keys, drivers):
            return fast_fn(params, state, keys, drivers)

        def fwd(params, state, keys, drivers):
            return fast_fn(params, state, keys, drivers), (
                params, state, keys, drivers)

        def bwd(res, ct):
            params, state, keys, drivers = res
            _, vjp = jax.vjp(
                lambda p, s, d: scan_fn(p, s, keys, d),
                params, state, drivers)
            dp, ds, dd = vjp(ct)
            dk = jax.tree.map(jnp.zeros_like, keys)
            return dp, ds, dk, dd

        render.defvjp(fwd, bwd)
        return render

    def render(self, n_samples: int, *, params: Optional[dict] = None,
               state: Optional[dict] = None, key=None, drivers=None,
               automation: Optional[dict] = None,
               batched: bool = False, engine: str = "auto",
               segment: Optional[int] = None):
        """Render ``n_samples``.

        Returns ``(audio, probes, final_state)`` where audio is
        ``[channels, n]`` (batched: ``[V, channels, n]``).  Pass the returned
        state back in to continue a render seamlessly -- module state carries
        across calls exactly as the reference's module fields persist across
        ``calc`` ticks (SURVEY.md §5 long-context).

        ``engine``: ``"scan"`` (one ``lax.scan`` over samples, runs
        everywhere), ``"block"`` (block engine), ``"fused"`` (the
        voice-kernel shell: GPU, batched, register-friendly patches only),
        or ``"auto"`` (:meth:`auto_engine`).

        ``segment``: render on device in ``segment``-sample pieces under one
        ``lax.scan`` (must divide ``n_samples``) -- one dispatch, state
        carried, live intermediates bounded to a segment.  The long-render
        escape hatch for lengths whose whole-render lanes OOM HBM (same
        semantics as :func:`srack_tpu.engine.render_long`, minus the
        per-segment host round trip).
        """
        if engine == "auto":
            engine = self.auto_engine(batched)
        if params is None:
            params = self.default_params
        if state is None:
            state = self.init_state()
            if batched:
                # broadcast fresh state over the leading batch axis of params
                v = jax.tree.leaves(params)[0].shape[0]
                state = jax.tree.map(
                    lambda a: jnp.broadcast_to(a, (v,) + a.shape), state)
        if key is None:
            key = jax.random.PRNGKey(0)
        elif isinstance(key, int):
            key = jax.random.PRNGKey(key)
        if batched and key.ndim == 1:
            v = jax.tree.leaves(params)[0].shape[0]
            key = jax.random.split(key, v)
        drv = {}
        if drivers:
            for module, arr in drivers.items():
                mid = module.id if isinstance(module, ModuleHandle) else module
                drv[mid] = arr
        if automation:
            for (module, pname), arr in automation.items():
                mid = (module.id if isinstance(module, ModuleHandle)
                       else module)
                if (mid, pname) not in self.automation:
                    raise KeyError(
                        f"({mid!r}, {pname!r}) was not declared at compile "
                        f"time; pass it in compile_patch(automation=...) / "
                        f"render(patch, automation=...)")
                drv[self._auto_key(mid, pname)] = arr
        if batched and drv:
            v = jax.tree.leaves(params)[0].shape[0]
            drv = {k: (jnp.broadcast_to(a, (v,) + jnp.shape(a))
                       if jnp.ndim(a) == 1 else jnp.asarray(a))
                   for k, a in drv.items()}
        fn = self._get_fn(int(n_samples), batched, engine,
                          segment=None if segment is None else int(segment))
        return fn(params, state, key, drv)


def migrate_state(old: "CompiledPatch", new: "CompiledPatch",
                  state: dict) -> dict:
    """Carry a live render's state across a topology edit.

    The reference rewires patches *while they play*: the UI re-plans and
    swaps the plan under a mutex (src/ui.rs:63-82, re-plan trigger
    ui.rs:568-570) and every module keeps its state across the swap because
    modules are long-lived objects (src/synth/oscillator.rs:151-152 ``pos``
    persists across calc calls).  Here a topology edit produces a new
    ``CompiledPatch`` whose ``init_state()`` starts cold; this function is
    the plan-swap analogue: modules present in both programs (same id, same
    type, same statics) keep their state leaves verbatim, new modules start
    from ``init_state``, and feedback lanes re-key (persisting wires carry,
    new wires start silent).

    Works on unbatched and batched state (the batch prefix is inferred from
    the carried leaves and applied to fresh ones).  A changed
    ``AudioConfig`` re-initialises everything: state dtypes/shapes are
    config-dependent (precision, block_size).
    """
    import numpy as np

    fresh = new.init_state()
    old_init = jax.eval_shape(old.init_state)
    new_init = jax.eval_shape(new.init_state)

    def _same_struct(mid: str) -> bool:
        # the carried leaves conform to OLD's state layout; they are only
        # safe to hand to NEW if that layout is identical (a custom module
        # unregistered and re-registered between edits may share its
        # type_name but carry a different state pytree)
        a, b = old_init["states"].get(mid), new_init["states"].get(mid)
        if a is None or b is None:
            return False
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        return (jax.tree.structure(a) == jax.tree.structure(b)
                and all(x.shape == y.shape and x.dtype == y.dtype
                        for x, y in zip(la, lb)))

    if old.cfg != new.cfg:
        carried_ids: set = set()
    else:
        # identity is (type_name, statics) -- NOT the ModuleDef object: a
        # re-registered custom module (modules.unregister + register round
        # trip) is a new ModuleDef object but the same live module, and its
        # state must survive the edit like any other
        carried_ids = {
            mid for mid, (mdef, statics, _) in new.instances.items()
            if mid in old.instances
            and old.instances[mid][0].type_name == mdef.type_name
            and old.instances[mid][1] == statics
            and mid in state["states"]
            and _same_struct(mid)
        }

    # infer the batch prefix by comparing one carried leaf against the
    # unbatched init shape of the same leaf
    prefix: tuple = ()
    for mid in sorted(state["states"]):
        if mid not in old_init["states"]:
            continue
        live = jax.tree.leaves(state["states"][mid])
        base = jax.tree.leaves(old_init["states"][mid])
        if live and base and len(live) == len(base):
            nd = np.ndim(live[0]) - len(base[0].shape)
            if nd > 0:
                prefix = tuple(np.shape(live[0])[:nd])
            break

    def bcast(tree):
        if not prefix:
            return tree
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, prefix + a.shape), tree)

    states = {
        mid: (state["states"][mid] if mid in carried_ids
              else bcast(fresh["states"][mid]))
        for mid in new.instances
    }
    fb = {}
    for k in new.fb_keys:
        live = state["fb"].get(k)
        init = fresh["fb"][k]
        if (live is not None and old.cfg == new.cfg
                and np.shape(live)[np.ndim(live) - init.ndim:]
                == init.shape):
            fb[k] = live
        else:
            fb[k] = bcast(init)
    return {"states": states, "fb": fb}


_COMPILE_CACHE = _LRU(COMPILE_CACHE_CAP)


def compile_patch(patch: Patch, probes: Sequence = (),
                  automation: Sequence = ()) -> CompiledPatch:
    """Compile a patch, cached by topology (module types + statics + wiring;
    param values excluded, so slider edits reuse the compiled program --
    SURVEY.md §7 hard part e).  ``automation``: (module, param) pairs whose
    values stream per-sample (part of the program structure, hence a compile
    argument; the arrays themselves go to render)."""
    probes_key = tuple(
        ((m.id if isinstance(m, ModuleHandle) else m), p) for m, p in probes)
    autos_key = tuple(sorted(
        ((m.id if isinstance(m, ModuleHandle) else m), p)
        for m, p in automation))
    key = (patch.topology_key(), probes_key, autos_key)
    cached = _COMPILE_CACHE.get(key)
    if cached is None:
        cached = CompiledPatch(patch, probes=probes, automation=autos_key)
        _COMPILE_CACHE.put(key, cached)
    else:
        # refresh default params (they may have changed without recompiling)
        cached.default_params = patch.params()
    return cached
