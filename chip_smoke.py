#!/usr/bin/env python
"""Smoke run of the system's main paths on one NVIDIA GPU.

    python chip_smoke.py               # phases 0-6 on one card
    python chip_smoke.py --four-cards  # the four-card farm + training only

Everything runs in this one process (a second JAX process could not get the
card's memory).  Each phase prints one line with its numbers and the
tolerance it is held to; any failed check raises, so the exit code is
non-zero and no result line is printed.  The last line is one JSON object
naming the device as JAX reports it.  Without a GPU the script exits 1
before any phase.

Phases (one card):
  0  device: platform check, card name and power limit, versions
  1  headline: subtractive voice, 1,024 voices x 480,000 samples through
     render(batched=True, engine="auto") -- the voice-kernel shell --
     checked against the scan engine on 64 voices x 48,000 samples
  2  sine, feedback and sequencer presets, 1,024 x 48,000, vs the scan
  3  block engine (drums, sampler, reverb), 1,024 x 96,000, serial stage
     in the shell, vs the scan engine on 32 voices
  4  training: batched_train_step(fast=True), 1,024 x 48,000, 3 steps;
     shell gradients vs scan autodiff on 32 voices x 4,096 samples
  5  streaming: render_stream blocks continue one whole render
  6  exact mode (x64): block engine vs the NumPy oracle
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

import srack_tpu as st
from srack_tpu import presets
from srack_tpu.utils import compile_cache

SR = 48000


def say(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args):
    """(result, seconds) of one call, waiting for the device."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def batch(compiled, v):
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    return state, keys


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max |diff| {err:.3e} > {tol:.1e}")


def check_audio(name: str, audio, shape) -> float:
    audio = np.asarray(audio)
    if audio.shape != shape:
        raise AssertionError(f"{name}: shape {audio.shape} != {shape}")
    if not np.isfinite(audio).all():
        raise AssertionError(f"{name}: non-finite samples")
    return float(np.abs(audio).max())


def state_err(sa, sb) -> float:
    return max(max_err(a, b) for a, b in
               zip(jax.tree.leaves(sa), jax.tree.leaves(sb)))


def render_pair(compiled, params, n, v_cmp, engine):
    """Render ``v_cmp`` voices on ``engine`` and on the scan engine."""
    p = jax.tree.map(lambda a: a[:v_cmp], params)
    state, keys = batch(compiled, v_cmp)
    a, _, s = compiled.render(n, params=p, state=state, key=keys,
                              batched=True, engine=engine)
    b, _, t = compiled.render(n, params=p, state=state, key=keys,
                              batched=True, engine="scan")
    return a, s, b, t


def phase_device(card: str) -> None:
    from importlib.metadata import version
    dev = jax.devices()[0]
    say(f"[0 device] {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"jax {jax.__version__}, jaxlib {version('jaxlib')}")
    say(f"[0 device] nvidia-smi name, power.limit: {card}")


def phase_headline(cfg, card: str) -> None:
    patch = presets.subtractive_voice(cfg)
    compiled = st.compile_patch(patch)
    engine = compiled.auto_engine(batched=True)
    if engine != "fused":
        raise AssertionError(f"auto chose {engine!r}, not the shell")
    v, n = 1024, 10 * SR
    params = presets.farm_params(patch, v)
    state, keys = batch(compiled, v)

    def go():
        return compiled.render(n, params=params, state=state, key=keys,
                               batched=True, engine="auto")[0]

    _, first = timed(go)
    audio, best = timed(go)
    peak = check_audio("headline", audio, (v, 1, n))
    say(f"[1 headline] subtractive x{v} x{n}: engine={engine}, first call "
        f"{first:.2f}s (compile included), run {best * 1e3:.1f} ms = "
        f"{v * n / best / 1e9:.3f} G samples/s, peak {peak:.3f} "
        f"[{card}]")
    a, s, b, t = render_pair(compiled, params, SR, 64, "fused")
    err, serr = max_err(a, b), state_err(s, t)
    say(f"[1 headline] vs scan engine, 64 voices x {SR}: audio {err:.2e}, "
        f"final state {serr:.2e} (tol 1e-5)")
    check("headline audio", err, 1e-5)
    check("headline state", serr, 1e-5)


def phase_presets(cfg) -> None:
    v, n = 1024, SR
    for name, make, n_cmp in (("sine", presets.sine_patch, n),
                              ("feedback", presets.feedback_patch, 4096),
                              ("sequencer", presets.sequencer_patch, n)):
        patch = make(cfg)
        compiled = st.compile_patch(patch)
        if compiled.auto_engine(batched=True) != "fused":
            raise AssertionError(f"{name}: auto did not choose the shell")
        params = presets.farm_params(patch, v)
        state, keys = batch(compiled, v)

        def go(eng):
            return compiled.render(n, params=params, state=state, key=keys,
                                   batched=True, engine=eng)

        (a, _, s), t_first = timed(go, "fused")
        (a, _, s), t_shell = timed(go, "fused")
        (b, _, t), t_scan = timed(go, "scan")
        check_audio(name, a, (v, 1, n))
        err = max_err(a[..., :n_cmp], b[..., :n_cmp])
        note = ""
        if n_cmp < n:
            note = (" (first 4,096 samples: cross-FM feedback amplifies "
                    "last-bit differences)")
        else:
            serr = state_err(s, t)
            note = f", final state {serr:.2e}"
            check(f"{name} state", serr, 1e-5)
        say(f"[2 {name}] x{v} x{n}: shell {t_shell * 1e3:.1f} ms "
            f"(first {t_first:.2f}s), scan engine {t_scan * 1e3:.1f} ms; "
            f"vs scan {err:.2e}{note} (tol 1e-5)")
        check(f"{name} audio", err, 1e-5)


def phase_block(cfg) -> None:
    v, n = 1024, 2 * SR
    for name, make, channels in (("drums", presets.drum_machine, 1),
                                 ("sampler", presets.sampler_kit, 1),
                                 ("reverb", presets.reverb_patch, 2)):
        patch = make(st.AudioConfig(sample_rate=SR, block_size=1024,
                                    channels=channels, precision="fast"))
        compiled = st.compile_patch(patch)
        if compiled.auto_engine(batched=True) != "block":
            raise AssertionError(f"{name}: auto did not choose the block "
                                 "engine")
        if not compiled.block_program()._use_shell(False):
            raise AssertionError(f"{name}: serial stage not in the shell")
        params = presets.farm_params(patch, v)
        state, keys = batch(compiled, v)

        def go():
            return compiled.render(n, params=params, state=state, key=keys,
                                   batched=True, engine="auto")[0]

        _, t_first = timed(go)
        audio, t_run = timed(go)
        peak = check_audio(name, audio, (v, channels, n))
        a, s, b, t = render_pair(compiled, params, n, 32, "block")
        err = max_err(a, b)
        # Freeverb's block impl leaves its ring buffers rotated to write
        # index 0, the scan engine does not: equal states, other layout
        serr = 0.0 if name == "reverb" else state_err(s, t)
        # the block impls reassociate float prefix sums (Freeverb's comb
        # solve, oscillator shadow phases): the CPU block-vs-scan tests
        # hold presets to 5e-6 over 512 samples; 96,000 samples of
        # resonant recurrences get 1e-4
        say(f"[3 {name}] x{v} x{n}: block engine {t_run * 1e3:.1f} ms "
            f"(first {t_first:.2f}s), peak {peak:.3f}; vs scan on 32 "
            f"voices: audio {err:.2e}, state {serr:.2e} (tol 1e-4; reverb "
            f"rings compared through audio only)")
        check(f"{name} audio", err, 1e-4)
        check(f"{name} state", serr, 1e-4)


def phase_training(cfg) -> None:
    import optax
    from srack_tpu.utils.train import SoundMatcher, batched_train_step

    patch = presets.subtractive_voice(cfg)
    compiled = st.compile_patch(patch)
    v, n = 1024, SR
    ts = SoundMatcher(patch, n).init()
    opt = optax.adam(1e-2)
    step = jax.jit(batched_train_step(compiled, opt, n, fast=True))
    targets = jnp.zeros((v, 1, n), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), v)
    train, opt_state = ts["train"], opt.init(ts["train"])
    losses, times = [], []
    for _ in range(3):
        (train, opt_state, loss), dt = timed(
            step, train, ts["frozen"], opt_state, targets, keys)
        losses.append(float(loss))
        times.append(dt)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"training losses {losses} not falling")
    say(f"[4 training] x{v} x{n}, fast=True: losses "
        f"{', '.join(f'{l:.6f}' for l in losses)}; steps "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms (first compiles)")

    # gradients: shell VJP vs scan autodiff
    vg, ng = 32, 4096
    params = presets.farm_params(patch, vg)
    state, keys = batch(compiled, vg)
    w = jax.random.normal(jax.random.PRNGKey(7), (vg, 1, ng))
    fast = compiled.grad_render_fn(ng, batched=True)
    scan = compiled.make_render_fn(ng, batched=True)

    def loss_of(fn):
        def loss(p):
            return jnp.sum(fn(p, state, keys, {})[0] * w)
        return loss

    with jax.default_matmul_precision("highest"):
        g1 = jax.jit(jax.grad(loss_of(fast)))(params)
        g2 = jax.jit(jax.grad(loss_of(scan)))(params)
    worst, live = 0.0, 0
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.dtype.kind != "f" or not b.size:
            continue
        worst = max(worst, float(np.abs(a - b).max())
                    / (1e-8 + 1e-4 * np.abs(b).max()))
        live += bool(np.abs(b).max() > 0)
    say(f"[4 training] grads vs scan autodiff, {vg} voices x {ng}: worst "
        f"|diff| / (1e-8 + 1e-4 max|g|) = {worst:.3f} (tol 1), {live} "
        f"param leaves with nonzero gradient")
    if not (worst <= 1.0 and live >= 4):
        raise AssertionError("shell gradients disagree with scan autodiff")


def phase_stream(cfg) -> None:
    patch = presets.subtractive_voice(cfg)
    compiled = st.compile_patch(patch)
    v, blocks = 1024, 8
    params = presets.farm_params(patch, v)
    got = [a for a, _, _ in st.render_stream(
        patch, params=params, voices=v, n_blocks=blocks)]
    got = np.concatenate([np.asarray(a) for a in got], axis=-1)
    n = blocks * cfg.block_size
    state, keys = batch(compiled, v)
    whole = compiled.render(n, params=params, state=state, key=keys,
                            batched=True)[0]
    err = max_err(got, whole)
    say(f"[5 stream] {blocks} blocks of {cfg.block_size} x{v} voices vs one "
        f"{n}-sample render: {err:.2e} (tol 1e-5)")
    check("stream continuity", err, 1e-5)


def phase_exact() -> None:
    from srack_tpu.oracle import oracle_render

    jax.config.update("jax_enable_x64", True)
    cfg = st.AudioConfig(sample_rate=SR, block_size=1024, channels=1,
                         precision="exact")
    patch = presets.subtractive_voice(cfg)
    compiled = st.compile_patch(patch)
    v, n = 8, 24000
    params = st.replicate_params(compiled.default_params, v)
    (audio, _, _), dt = timed(lambda: compiled.render(
        n, params=params, batched=True, engine="block"))
    want = oracle_render(patch, n)
    err = max_err(audio, np.broadcast_to(want, (v,) + want.shape))
    # the per-module oracle tests hold 384-sample patches to 1e-6; over
    # 24,000 samples the sawtooth's polyBLEP and the resonant ladder
    # amplify last-bit f32 differences -- the same comparison reads
    # 5.5e-5 on the CPU
    say(f"[6 exact] block engine, x64, {v} voices x {n} vs oracle: "
        f"{err:.2e} (tol 1e-4), {dt:.2f}s")
    check("exact vs oracle", err, 1e-4)


def phase_four_cards() -> None:
    import optax
    from srack_tpu.parallel import make_mesh, render_farm
    from srack_tpu.parallel.mesh import batch_sharding, replicated
    from srack_tpu.utils.train import SoundMatcher, batched_train_step

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found "
                             f"{len(jax.devices())}")
    cfg = st.AudioConfig(sample_rate=SR, block_size=1024, channels=1,
                         precision="fast")
    patch = presets.subtractive_voice(cfg)
    compiled = st.compile_patch(patch)
    mesh = make_mesh(4)
    v, n = 4096, SR
    params = presets.farm_params(patch, v)
    (mixed, _, final), t_farm = timed(
        lambda: render_farm(patch, n, params=params, mesh=mesh,
                            mixdown=True))
    leaf = jax.tree.leaves(final)[0]
    shards = ", ".join(f"{s.device.id}:{tuple(s.data.shape)}"
                       for s in leaf.addressable_shards)
    say(f"[4 cards] farm x{v} x{n} on mesh {dict(mesh.shape)}: "
        f"{t_farm:.2f}s; state shards (device:shape) {shards}")
    one = jax.devices()[0]
    p1 = jax.device_put(params, one)
    state, keys = batch(compiled, v)
    local = compiled.render(n, params=p1, state=state, key=keys,
                            batched=True)[0]
    local = np.asarray(local, np.float64)
    err = max_err(mixed, local.sum(axis=0))
    # f32 sums of 4,096 voices in another order: bound by the summed
    # magnitude, not the sum
    tol = 1e-5 * float(np.abs(local).sum(axis=0).max())
    say(f"[4 cards] mixdown vs one card summed: {err:.2e} (tol {tol:.1e} "
        f"= 1e-5 x max sum of |voice|)")
    check("farm mixdown", err, tol)

    ts = SoundMatcher(patch, n).init()
    opt = optax.sgd(1e-2)
    vt = 1024
    targets = jnp.full((vt, 1, n), 0.01, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), vt)
    bsh, rep = batch_sharding(mesh), replicated(mesh)
    sharded = jax.jit(batched_train_step(compiled, opt, n, fast=True,
                                         mesh=mesh),
                      in_shardings=(rep, rep, rep, bsh, bsh),
                      out_shardings=(rep, rep, rep))
    single = jax.jit(batched_train_step(compiled, opt, n, fast=True))
    o0 = opt.init(ts["train"])
    tk = jax.device_put(keys, bsh)
    tt = jax.device_put(targets, bsh)
    (t4, _, l4), dt4 = timed(sharded, ts["train"], ts["frozen"], o0, tt, tk)
    shards = ", ".join(f"{s.device.id}:{tuple(s.data.shape)}"
                       for s in tt.addressable_shards)
    (t1, _, l1), dt1 = timed(single, ts["train"], ts["frozen"], o0,
                             targets, keys)
    perr = max(max_err(a, b) for a, b in
               zip(jax.tree.leaves(t4), jax.tree.leaves(t1)))
    say(f"[4 cards] train step x{vt}: 4 cards {dt4:.2f}s, one card "
        f"{dt1:.2f}s (compile included); target shards {shards}; loss "
        f"{float(l4):.6e} vs {float(l1):.6e}; params {perr:.2e} (tol 1e-5)")
    check("sharded loss", abs(float(l4) - float(l1)), 1e-5 * abs(float(l1))
          + 1e-9)
    check("sharded params", perr, 1e-5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card farm and training phase")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", " | ")
    phase_device(card)
    if args.four_cards:
        phase_four_cards()
    else:
        cfg = st.AudioConfig(sample_rate=SR, block_size=1024, channels=1,
                             precision="fast")
        phase_headline(cfg, card)
        phase_presets(cfg)
        phase_block(cfg)
        phase_training(cfg)
        phase_stream(cfg)
        phase_exact()
    say(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
