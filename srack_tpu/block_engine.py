"""Stage-partition block engine.

The scan engine runs the *whole* graph once per sample; the fused kernel
(ops/fused.py) removes XLA loop overhead but still walks the full module
chain serially 48,000 times a second -- at 1k voices it is latency-bound on
the per-sample dependency chain.  This engine shrinks the serial region to
its true minimum:

1. **Classify.**  A module is *serial* if its per-sample recurrence has no
   closed-form parallel scan (Moog ladder, ADSR, Sample, Freeverb) or if it
   sits on a feedback cycle (every cycle member needs per-sample state --
   including block-capable modules like the cross-FM Multiply).  Everything
   else is *block-capable*: elementwise (Math, VCA, Mixer, Output, ...) or
   prefix-sum parallel (oscillator phase = segmented cumsum; sequencer step
   pointer = segmented edge count).

2. **Partition.**  With S the serial set: ``pre`` = modules with no path
   from S (computable up front, whole-block), ``middle`` = block modules
   sandwiched between serial modules (must run per-sample), ``post`` = the
   rest.  The serial *stage* = S ∪ middle in plan order.

3. **Execute.**  ``pre`` runs as [n]-vectorised XLA ops (vmapped over
   voices -- large fusable elementwise tensors); the stage runs per-sample
   over streamed input wires -- on a GPU in the voice-kernel shell
   (ops/shell.py, chosen by route.voice_kernel), elsewhere as a lax.scan;
   ``post`` runs block-wise on the stage's output wires.

Role: the fused engine (the whole patch in the shell, state in registers)
wins for patches made purely of register-friendly modules; this engine is
the path for everything *else* -- patches with sample players or long
delay lines (Freeverb) whose block implementations are prefix-scan and
gather code that cannot live inside the shell.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import route
from .config import AudioConfig
from .modules.base import CV_DTYPE
from .ops import fused, shell

# module types the block engine runs per-sample in the serial stage.
# Moog's ladder recurrence has no parallel-prefix form.  ADSR *does* have
# a segment-parallel whole-block form (ops/adsr_block.py): the envelope is
# ~15 register ops per sample in the serial stage, while the event-classify
# machinery needs ~10 full-block elementwise passes per fixed-point round.
# Freeverb and Sample stay block-side: delay lines are chunk-parallel,
# triggered playback is segment-parallel.
SERIAL_TYPES = frozenset({"Moog Filter", "ADSR"})

# serial-stage types safe for the shell: exactly the fused engine's "pure
# register math" set -- one definition so a new register-friendly type
# changes eligibility for both paths in lockstep.
PALLAS_SAFE = fused.REGISTER_TYPES


def _sccs(nodes, deps):
    """Tarjan strongly-connected components (iterative)."""
    index = {}
    low = {}
    on_stack = set()
    stack = []
    result = []
    counter = [0]

    for start in nodes:
        if start in index:
            continue
        work = [(start, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            succs = deps[node]
            for i in range(pi, len(succs)):
                s = succs[i]
                if s not in index:
                    work[-1] = (node, i + 1)
                    work.append((s, 0))
                    recurse = True
                    break
                elif s in on_stack:
                    low[node] = min(low[node], index[s])
            if recurse:
                continue
            work.pop()
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                result.append(comp)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return result


class BlockProgram:
    """The partitioned execution plan for one compiled patch."""

    def __init__(self, compiled):
        self.compiled = compiled
        self.cfg: AudioConfig = compiled.cfg
        insts = compiled.instances
        plan = compiled.plan
        plan_pos = compiled.plan_pos
        # buffer-feedback compat mode (synth.rs:168-192 previous-buffer
        # reads): a feedback edge carries a whole block-delayed lane, so it
        # is NOT a dependency within one block -- the graph is acyclic at
        # block granularity and everything runs block-parallel under an
        # outer scan over blocks.
        self.buffer_mode = self.cfg.buffer_feedback

        def is_fb(conn, mid):
            return plan_pos[conn[0]] >= plan_pos[mid]

        self._is_fb = is_fb

        deps = {mid: [c[0] for c in insts[mid][2]
                      if c is not None
                      and not (self.buffer_mode and is_fb(c, mid))]
                for mid in insts}
        consumers = {mid: [] for mid in insts}
        for mid, ds in deps.items():
            for d in ds:
                consumers[d].append(mid)

        serial = {mid for mid, (mdef, _, _) in insts.items()
                  if mdef.type_name in SERIAL_TYPES}
        # parameter automation: modules whose block impl handles per-sample
        # param lanes (ModuleDef.auto_block_params) stay block-capable; any
        # other automated module joins the serial stage, where the lane
        # streams in per sample (exact semantics)
        autos = dict(getattr(compiled, "_auto_by_mid", {}) or {})
        for mid, pnames in autos.items():
            if not set(pnames) <= insts[mid][0].auto_block_params:
                serial.add(mid)
        # feedback cycles force per-sample execution for all members
        # (buffer mode: fb edges are excluded from deps, so no cycles left)
        for comp in _sccs(list(insts), deps):
            if len(comp) > 1 or comp[0] in deps[comp[0]]:
                serial.update(comp)
        # block-capable only with a block impl or empty state (elementwise)
        for mid, (mdef, statics, _) in insts.items():
            if mid in serial:
                continue
            has_block = mdef.block is not None
            stateless = not mdef.init_state(self.cfg, statics)
            if not (has_block or stateless):
                serial.add(mid)

        def reach(seed, adj):
            seen = set(seed)
            frontier = list(seed)
            while frontier:
                m = frontier.pop()
                for s in adj[m]:
                    if s not in seen:
                        seen.add(s)
                        frontier.append(s)
            return seen

        def _safe(mid):
            mdef = insts[mid][0]
            return mdef.type_name in PALLAS_SAFE or mdef.register_safe

        def _has_carry(mids):
            return any(jax.tree.leaves(
                insts[m][0].init_state(self.cfg, insts[m][1]))
                for m in mids)

        # -- synthesized stage seed: patches with no serial core (e.g. the
        # sampler kit: clock + sequencer + Samples + mixer) still pay the
        # XLA block impls' whole-render prefix machinery (the sequencer's
        # monotone_fill alone materializes [n, V] log-doubling passes).
        # Seed a stage from the register-safe ANCESTORS of the non-safe
        # modules so that machinery runs per sample in registers instead;
        # adopted only if the implied stage is wholly shell-safe and has a
        # state carry.
        if not serial and not self.cfg.exact:
            unsafe = {m for m in insts if not _safe(m)}
            safe_anc = {m for m in reach(unsafe, deps) - unsafe
                        if _safe(m) and m != compiled.output_id}
            if safe_anc and _has_carry(safe_anc):
                cand = safe_anc | ((reach(safe_anc, consumers)
                                    & reach(safe_anc, deps)) - safe_anc)
                if all(_safe(m) for m in cand):
                    serial = safe_anc

        desc = reach(serial, consumers)   # depend on serial (incl. serial)
        anc = reach(serial, deps)         # serial depends on them
        self.stage_set = serial | ((desc & anc) - serial)
        # pre = what the stage (transitively) depends on; everything else
        # outside the stage runs POST -- modules parallel to the stage
        # (e.g. a Sample beside the drum voices) go post so their safe
        # producers (clock, sequencers) stay absorbable below.
        pre_set = {m for m in plan
                   if m in anc and m not in self.stage_set}
        post_set = {m for m in plan
                    if m not in self.stage_set and m not in pre_set}

        # -- stage absorption: grow the stage over register-safe ------------
        # neighbors.  The XLA block impls of register-math modules
        # (oscillator prefix sums, sequencer edge counts, elementwise
        # chains) cost several full-memory passes each, while the same
        # modules inside the per-sample stage cost roughly their op count
        # in registers.  A pre module is
        # absorbed when every consumer is already stage/post-side
        # (reverse plan order reaches the fixpoint in one sweep); a post
        # module when every producer is pre/stage-side (forward order) --
        # so the pre -> stage -> post plan-order invariant is preserved.
        # Only when the existing stage is already shell-eligible:
        # growing a lax.scan-fallback stage would pessimize it.  The
        # Output module never joins (make_run routes channels through the
        # block phases).
        if (self.stage_set and not self.cfg.exact
                and all(_safe(m) for m in self.stage_set)):
            for m in reversed(plan):
                if (m in pre_set and _safe(m)
                        and m != compiled.output_id
                        and all(c in self.stage_set or c in post_set
                                for c in consumers[m])):
                    pre_set.discard(m)
                    self.stage_set.add(m)
            for m in plan:
                if (m in post_set and _safe(m)
                        and m != compiled.output_id
                        and all(d in pre_set or d in self.stage_set
                                for d in deps[m])):
                    post_set.discard(m)
                    self.stage_set.add(m)

        self.pre_plan = [m for m in plan if m in pre_set]
        self.stage_plan = [m for m in plan if m in self.stage_set]
        self.post_plan = [m for m in plan if m in post_set]
        self.stage_in = sorted({
            c for mid in self.stage_plan for c in insts[mid][2]
            if c is not None and c[0] in pre_set
            and not (self.buffer_mode and is_fb(c, mid))})
        # buffer mode: block-delayed lanes consumed by stage modules stream
        # into the serial kernel as extra per-sample inputs
        self.stage_fb_in = sorted({
            c for mid in self.stage_plan for c in insts[mid][2]
            if c is not None and is_fb(c, mid)}) if self.buffer_mode else []
        stage_out = {
            c for mid in self.post_plan for c in insts[mid][2]
            if c is not None and c[0] in self.stage_set
            and not (self.buffer_mode and is_fb(c, mid))}
        # probe taps on stage modules become extra stage outputs
        self.probe_wires = list(compiled.probes)
        stage_out.update(w for w in self.probe_wires
                         if w[0] in self.stage_set)
        # buffer mode: fb wires sourced inside the stage must come out so
        # the next block can read them
        if self.buffer_mode:
            stage_out.update(k for k in compiled.fb_keys
                             if k[0] in self.stage_set)
        self.stage_out = sorted(stage_out)

        self.pallas_ok = all(
            insts[mid][0].type_name in PALLAS_SAFE
            or insts[mid][0].register_safe for mid in self.stage_plan
        ) and not self.cfg.exact

        # automation lane routing: stage modules consume their lanes per
        # sample; block-phase modules get params overlaid with [n] lanes
        self.stage_autos = tuple(
            (mid, p) for mid in self.stage_plan for p in autos.get(mid, ()))
        self._stage_autos_by_mid = {
            mid: tuple(ps) for mid, ps in autos.items()
            if mid in self.stage_set}
        self._block_autos = {
            mid: tuple(ps) for mid, ps in autos.items()
            if mid not in self.stage_set}

    # -- block phases --------------------------------------------------------

    def _run_block_phase(self, plan_subset, params, states, values, xs, n,
                         fb=None):
        """Run block-capable modules over whole [n] wires (unbatched).

        ``fb`` (buffer mode): block-delayed lanes; an input whose source is
        planned at-or-after its sink reads the delayed lane -- the same
        whatever-is-in-the-buffer rule as compiler._sample_step.
        """
        cfg = self.cfg
        insts = self.compiled.instances
        new_states = {}
        channels = None
        for mid in plan_subset:
            mdef, statics, inputs = insts[mid]
            ins = [None if c is None else
                   (fb[c] if fb is not None and self._is_fb(c, mid)
                    else values[c])
                   for c in inputs]
            x = xs.get(mid)
            pd = params[mid]
            auto = self._block_autos.get(mid)
            if auto:
                # per-sample automation lanes overlay the static params
                # (the module's block impl / stateless step handles the
                # [n] shape -- gated by ModuleDef.auto_block_params)
                pd = {**pd, **{p: xs[self.compiled._auto_key(mid, p)][:n]
                               for p in auto}}
            with jax.named_scope(f"{mdef.type_name}:{mid}"):
                if mdef.block is not None:
                    new_state, outs = mdef.block(
                        cfg, statics, pd, states[mid], ins, x, n)
                else:
                    new_state, outs = (mdef.step_nograd or mdef.step)(
                        cfg, statics, pd, states[mid], ins, x)
                    outs = tuple(jnp.broadcast_to(o, (n,)).astype(o.dtype)
                                 for o in outs)
            new_states[mid] = new_state
            for p, o in enumerate(outs):
                values[(mid, p)] = o
            if mid == self.compiled.output_id:
                channels = outs
        return new_states, channels

    # -- serial stage --------------------------------------------------------

    def _stage_step(self, params, states, fb, ext):
        """One sample through the serial stage.  ``ext``: {(src,port): val},
        plus -- in buffer mode -- {("fb", src, port): delayed val}."""
        cfg = self.cfg
        insts = self.compiled.instances
        plan_pos = self.compiled.plan_pos
        values = dict(ext)
        new_states = {}
        channels = None
        for mid in self.stage_plan:
            mdef, statics, inputs = insts[mid]
            ins = []
            for c in inputs:
                if c is None:
                    ins.append(None)
                elif self.buffer_mode and self._is_fb(c, mid):
                    ins.append(values[("fb",) + c])
                elif c[0] in self.stage_set and plan_pos[c[0]] >= plan_pos[mid]:
                    ins.append(fb[c])
                else:
                    ins.append(values[c])
            pd = params[mid]
            auto = self._stage_autos_by_mid.get(mid)
            if auto:
                # this sample's automation lane values overlay the params
                pd = {**pd, **{p: values[("auto", mid, p)] for p in auto}}
            # the block engine is never differentiated (grad_render_fn
            # routes to fused_vjp or scan), so gradient-only step ops are
            # elided (bit-identical primal; ModuleDef.step_nograd)
            # ``("x", mid)``: this sample's hoisted make_xs / driver lane
            # value, streamed in like the scan engine's x_t.get(mid)
            new_state, outs = (mdef.step_nograd or mdef.step)(
                cfg, statics, pd, states[mid], ins, values.get(("x", mid)))
            new_states[mid] = new_state
            for p, o in enumerate(outs):
                values[(mid, p)] = o
            if mid == self.compiled.output_id:
                channels = outs
        fb_out = {k: values[k] for k in fb}
        outs = {w: values[w] for w in self.stage_out}
        return new_states, fb_out, outs, channels


    # -- full program --------------------------------------------------------

    def make_run(self, n: int, interpret: bool = False):
        """Build ``run(params, state, key, drivers) -> (audio, {}, state)``
        over a leading voice axis (batched).  ``interpret=True`` (tests)
        runs a shell-eligible serial stage in the Pallas interpreter."""
        if self.buffer_mode:
            return self._make_run_buffer(n, interpret)
        compiled = self.compiled
        cfg = self.cfg
        n_channels = cfg.channels
        stage_has_output = compiled.output_id in self.stage_set
        stage_out_keys = list(self.stage_out)
        if stage_has_output:
            raise NotImplementedError(
                "Output module inside a feedback cycle is not supported by "
                "the block engine")

        def pre_fn(params, states, xs):
            values: dict = {}
            new_states, channels = self._run_block_phase(
                self.pre_plan, params, states, values, xs, n)
            wires = {w: values[w] for w in self.stage_in}
            extra = {}
            # wires consumed directly by post modules from pre
            for mid in self.post_plan:
                for c in compiled.instances[mid][2]:
                    if c is not None and c in values:
                        extra[c] = values[c]
            probes = {w: values[w] for w in self.probe_wires if w in values}
            return wires, extra, new_states, channels, probes

        def post_fn(params, states, wire_values, xs):
            values = dict(wire_values)
            new_states, channels = self._run_block_phase(
                self.post_plan, params, states, values, xs, n)
            probes = {w: values[w] for w in self.probe_wires if w in values}
            return new_states, channels, probes

        use_shell = self._use_shell(interpret)

        if self.stage_plan:
            def kernel_step(k_params, k_state, ins_dict):
                ext = {eval_key(k): v for k, v in ins_dict.items()}
                new_states, fb_out, outs, _ = self._stage_step(
                    k_params, k_state["states"], k_state["fb"], ext)
                out_lanes = {wire_key(w): outs[w] for w in stage_out_keys}
                return {"states": new_states, "fb": fb_out}, out_lanes

            def wire_key(w):
                return f"{w[0]}#{w[1]}"

            def eval_key(s):
                if s.startswith("auto:"):
                    mid, p = s[5:].rsplit("~", 1)
                    return ("auto", mid, p)
                if s.startswith("x:"):
                    return ("x", s[2:])
                mid, port = s.rsplit("#", 1)
                return (mid, int(port))

        def run(params, state, keys, drivers):
            v = jax.tree.leaves(params)[0].shape[0]
            xs_params = params
            params = compiled.derived_params(params)

            # hoisted per-sample lanes
            def one_xs(p, k):
                return compiled._make_xs(p, k, n, drivers={})
            xs = jax.vmap(one_xs)(xs_params, keys)
            for mid_h, arr in (drivers or {}).items():
                xs[mid_h] = jnp.asarray(arr, dtype=CV_DTYPE)

            states = state["states"]
            fb = state["fb"]

            wires, extra, pre_states, pre_channels, pre_probes = jax.vmap(
                lambda p, s, x: pre_fn(p, s, x))(params, states, xs)

            def probe_dict(*sources):
                out = {}
                for src in sources:
                    out.update(src)
                return {f"{mid}:{port}": arr
                        for (mid, port), arr in out.items()}

            if not self.stage_plan:
                # fully block-parallel patch
                post_states, channels, post_probes = jax.vmap(
                    lambda p, s, w, x: post_fn(p, s, w, x))(
                        params, states, {**wires, **extra}, xs)
                channels = pre_channels if channels is None else channels
                audio = jnp.stack(channels, axis=1)
                final = {"states": {**pre_states, **post_states}, "fb": fb}
                return audio, probe_dict(pre_probes, post_probes), final

            stage_params = {m: params[m] for m in self.stage_plan}
            stage_states = {m: states[m] for m in self.stage_plan}
            stage_state = {"states": stage_states, "fb": fb}
            ins_lanes = {wire_key(w): wires[w] for w in self.stage_in}
            for (mid_a, p_a) in self.stage_autos:
                ins_lanes[f"auto:{mid_a}~{p_a}"] = (
                    xs[compiled._auto_key(mid_a, p_a)])
            # hoisted make_xs / driver lanes of stage modules stream in per
            # sample (the scan/fused engines deliver these as x_t[mid])
            for mid_x in self.stage_plan:
                if mid_x in xs:
                    ins_lanes[f"x:{mid_x}"] = xs[mid_x]

            if use_shell:
                out_lanes, stage_final = shell.run(
                    kernel_step, n, stage_params, stage_state, ins_lanes,
                    [wire_key(w) for w in stage_out_keys],
                    interpret=interpret)
            else:
                def scan_one(sp, ss, lanes):
                    def body(carry, lane_t):
                        st, fbc = carry
                        ext = {eval_key(k): val for k, val in lane_t.items()}
                        ns, fo, outs, _ = self._stage_step(
                            sp, st, fbc, ext)
                        return (ns, fo), {wire_key(w): outs[w]
                                          for w in stage_out_keys}
                    lanes_t = {k: a for k, a in lanes.items()}
                    (sf, ff), outs = jax.lax.scan(
                        body, (ss["states"], ss["fb"]), lanes_t, length=n,
                        unroll=4)
                    return outs, {"states": sf, "fb": ff}
                out_lanes, stage_final = jax.vmap(scan_one)(
                    stage_params, stage_state, ins_lanes)

            stage_wire_values = {w: out_lanes[wire_key(w)]
                                 for w in stage_out_keys}

            post_states, channels, post_probes = jax.vmap(
                lambda p, s, w, x: post_fn(p, s, w, x))(
                    params, states,
                    {**wires, **extra, **stage_wire_values}, xs)

            channels = channels if channels is not None else pre_channels
            audio = jnp.stack(channels, axis=1)
            final_states = {**pre_states, **stage_final["states"],
                            **post_states}
            final = {"states": final_states, "fb": stage_final["fb"]}
            stage_probes = {w: stage_wire_values[w]
                            for w in self.probe_wires
                            if w in stage_wire_values}
            return audio, probe_dict(pre_probes, stage_probes,
                                     post_probes), final

        return run

    # -- buffer-feedback compat mode ------------------------------------------

    def _use_shell(self, interpret: bool) -> bool:
        return bool(self.pallas_ok and self.stage_plan
                    and (interpret or route.voice_kernel()))

    def _make_run_buffer(self, n: int, interpret: bool = False):
        """Reference-exact previous-buffer feedback on the block engine.

        One block is fully block-parallel (every fb edge reads the previous
        block's lane, so the within-block graph is acyclic); blocks chain
        under an outer ``lax.scan`` carrying module states + fb lanes --
        the same structure as compiler._render_buffer_mode but with the
        block phases vectorised and the serial stage in the shell.
        """
        compiled = self.compiled
        cfg = self.cfg
        block = cfg.block_size
        if n % block != 0:
            raise ValueError(
                f"buffer_feedback mode renders whole blocks: n={n} is not a "
                f"multiple of block_size={block}")
        n_blocks = n // block
        fb_keys = tuple(sorted(compiled.fb_keys))
        stage_out_keys = list(self.stage_out)
        if compiled.output_id in self.stage_set:
            raise NotImplementedError(
                "Output module in the serial stage is not supported by "
                "the block engine")

        def wire_key(w):
            if len(w) == 3:  # ("fb", src, port): block-delayed lane
                return f"fb:{w[1]}#{w[2]}"
            return f"{w[0]}#{w[1]}"

        def eval_key(s):
            if s.startswith("auto:"):
                mid, p = s[5:].rsplit("~", 1)
                return ("auto", mid, p)
            if s.startswith("x:"):
                return ("x", s[2:])
            fbp = s.startswith("fb:")
            if fbp:
                s = s[3:]
            mid, port = s.rsplit("#", 1)
            return ("fb", mid, int(port)) if fbp else (mid, int(port))

        def pre_fn(params, states, xs, fb):
            values: dict = {}
            new_states, channels = self._run_block_phase(
                self.pre_plan, params, states, values, xs, block, fb=fb)
            probes = {w: values[w] for w in self.probe_wires if w in values}
            return new_states, channels, probes, values

        def post_fn(params, states, wire_values, xs, fb):
            values = dict(wire_values)
            new_states, channels = self._run_block_phase(
                self.post_plan, params, states, values, xs, block, fb=fb)
            probes = {w: values[w] for w in self.probe_wires if w in values}
            return new_states, channels, probes, values

        use_shell = self._use_shell(interpret)
        if self.stage_plan:
            def kernel_step(k_params, k_state, ins_dict):
                ext = {eval_key(k): val for k, val in ins_dict.items()}
                new_states, fb_out, outs, _ = self._stage_step(
                    k_params, k_state["states"], k_state["fb"], ext)
                out_lanes = {wire_key(w): outs[w] for w in stage_out_keys}
                return {"states": new_states, "fb": fb_out}, out_lanes

        def one_block(params, states, fb, xs_b):
            pre_states, pre_channels, pre_probes, pre_values = jax.vmap(
                pre_fn)(params, states, xs_b, fb)
            stage_wire_values: dict = {}
            stage_final_states: dict = {}
            stage_probes: dict = {}
            if self.stage_plan:
                stage_params = {m: params[m] for m in self.stage_plan}
                stage_states = {m: states[m] for m in self.stage_plan}
                stage_state = {"states": stage_states, "fb": {}}
                ins_lanes = {wire_key(w): pre_values[w]
                             for w in self.stage_in}
                ins_lanes.update({wire_key(("fb",) + k): fb[k]
                                  for k in self.stage_fb_in})
                for (mid_a, p_a) in self.stage_autos:
                    ins_lanes[f"auto:{mid_a}~{p_a}"] = (
                        xs_b[compiled._auto_key(mid_a, p_a)])
                for mid_x in self.stage_plan:
                    if mid_x in xs_b:
                        ins_lanes[f"x:{mid_x}"] = xs_b[mid_x]
                if use_shell:
                    out_lanes, stage_final = shell.run(
                        kernel_step, block, stage_params, stage_state,
                        ins_lanes, [wire_key(w) for w in stage_out_keys],
                        interpret=interpret)
                else:
                    def scan_one(sp, ss, lanes):
                        def body(carry, lane_t):
                            st, fbc = carry
                            ext = {eval_key(k): val
                                   for k, val in lane_t.items()}
                            ns, fo, outs, _ = self._stage_step(
                                sp, st, fbc, ext)
                            return (ns, fo), {wire_key(w): outs[w]
                                              for w in stage_out_keys}
                        (sf, ff), outs = jax.lax.scan(
                            body, (ss["states"], ss["fb"]), lanes,
                            length=block, unroll=4)
                        return outs, {"states": sf, "fb": ff}
                    out_lanes, stage_final = jax.vmap(scan_one)(
                        stage_params, stage_state, ins_lanes)
                stage_wire_values = {w: out_lanes[wire_key(w)]
                                     for w in stage_out_keys}
                stage_final_states = stage_final["states"]
                stage_probes = {w: stage_wire_values[w]
                                for w in self.probe_wires
                                if w in stage_wire_values}

            post_states, channels, post_probes, post_values = jax.vmap(
                post_fn)(params, states,
                         {**pre_values, **stage_wire_values}, xs_b, fb)
            channels = channels if channels is not None else pre_channels
            audio = jnp.stack(channels, axis=1)
            new_states = {**pre_states, **stage_final_states, **post_states}
            all_values = {**pre_values, **stage_wire_values, **post_values}
            fb_out = {k: all_values[k] for k in fb_keys}
            probes = {**pre_probes, **stage_probes, **post_probes}
            return audio, probes, new_states, fb_out

        def run(params, state, keys, drivers):
            def one_xs(p, k):
                return compiled._make_xs(p, k, n, drivers={})
            xs = jax.vmap(one_xs)(params, keys)
            params = compiled.derived_params(params)
            for mid_h, arr in (drivers or {}).items():
                xs[mid_h] = jnp.asarray(arr, dtype=CV_DTYPE)

            def blocked(a):  # [V, n, ...] -> [n_blocks, V, block, ...]
                a = a.reshape((a.shape[0], n_blocks, block) + a.shape[2:])
                return jnp.moveaxis(a, 1, 0)
            xs_t = {k2: blocked(v) for k2, v in xs.items()}

            def outer(carry, xs_b):
                states, fb = carry
                audio_b, probes_b, ns, fb_out = one_block(
                    params, states, fb, xs_b)
                return (ns, fb_out), (audio_b, probes_b)

            (states_f, fb_f), (ys, pys) = jax.lax.scan(
                outer, (state["states"], state["fb"]), xs_t,
                length=n_blocks)
            # ys: [n_blocks, V, C, block] -> [V, C, n]
            audio = jnp.moveaxis(ys, 0, 2).reshape(
                ys.shape[1], ys.shape[2], n)
            probes = {
                f"{mid}:{port}": jnp.moveaxis(arr, 0, 1).reshape(
                    arr.shape[1], n)
                for (mid, port), arr in pys.items()}
            return audio, probes, {"states": states_f, "fb": fb_f}

        return run


def eligible(compiled) -> bool:
    """The block engine handles every patch the scan engine does: probes,
    buffer-feedback compat mode (outer scan over blocks; fb edges read the
    previous block's lanes, exactly the reference's previous-buffer timing,
    synth.rs:168-192), and parameter automation (stage modules stream
    lanes per sample -- exact; block-phase modules either handle [n]-lane
    params natively, ModuleDef.auto_block_params, or are pulled into the
    serial stage)."""
    return True
