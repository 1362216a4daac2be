#!/usr/bin/env python
"""Benchmark harness.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline metric (BASELINE.md north star): rendered audio samples/sec/chip —
1,000 concurrent subtractive voices (BASELINE config 2 topology) rendering
10 s of 48 kHz audio each on one chip, on the engine ``render(engine=
"auto")`` picks (on a GPU: the voice-kernel shell, ops/shell.py).
Baseline target: 4.8e9 samples/s (= 1000 voices x 100x real time x 48k).

Extra per-config numbers go to stderr; stdout carries only the JSON line.
Each timed call ends in a device fetch of the output's peak, so it includes
the dispatch and the fetch.

    python bench.py
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

import srack_tpu as st
from srack_tpu.utils import compile_cache
from srack_tpu.presets import (drum_machine, farm_params, feedback_patch,
                               reverb_patch, sampler_kit, sequencer_patch,
                               sine_patch, subtractive_voice)

BASELINE_SAMPLES_PER_SEC = 4.8e9

# (name, n, rate_G, peak) per config that completed, replayed as a compact
# stderr recap immediately before the stdout JSON line: an OOM dump mid-run
# must not push the secondary numbers out of the tail of the output.
RECAP: list[str] = []


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bench_config(name, patch, n, voices, engine="auto", repeats=5,
                 segment=None):
    # 5 repeats, min taken
    compiled = st.compile_patch(patch)
    params = farm_params(patch, voices)
    state = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (voices,) + a.shape),
        compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(0), voices)
    if engine == "auto":
        engine = compiled.auto_engine(batched=True)
    fn = compiled._get_fn(n, True, engine, segment=segment)
    # one dispatch per timed call: the on-device peak reduction both forces
    # execution and is the fetch
    meter = jax.jit(lambda p, s, k, d: jnp.abs(fn(p, s, k, d)[0]).max())
    t0 = time.perf_counter()
    peak = float(meter(params, state, keys, {}))
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        peak = float(meter(params, state, keys, {}))
        best = min(best, time.perf_counter() - t0)
    rate = n * voices / best
    rtf = rate / patch.config.sample_rate
    log(f"[{name}] engine={engine} voices={voices} n={n} "
        f"compile={compile_s:.1f}s "
        f"best={best * 1e3:.1f}ms rate={rate / 1e9:.3f}G samples/s "
        f"aggregate_rtf={rtf:.0f}x peak={peak:.3f}")
    # 0.2% headroom: the sine preset is a deliberately full-scale sine and
    # the fast-mode polynomial sine overshoots |1| by ~1e-5; the assert is
    # for wrong mixer gains (dB-scale clipping), not ulp overshoot
    if not peak <= 1.002:
        raise ValueError(f"[{name}] output clips: peak={peak:.3f} > 1.0 "
                         "-- preset gains are wrong")
    # recap only after the clip assert: a rejected config (or a retried
    # ladder rung) must not land in the driver-captured tail as a
    # completed result
    RECAP.append(f"{name}: {rate / 1e9:.2f}G (n={n} v={voices} "
                 f"peak={peak:.2f})")
    return rate


def main() -> None:
    compile_cache.enable()
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}")
    cfg = st.AudioConfig(sample_rate=48000, block_size=1024, channels=1,
                         precision="fast")

    # headline: BASELINE spec asks for >=1000 concurrent subtractive voices;
    # we render 1024 (32 blocks of the shell's 32 voices).  Degrade to
    # shorter renders rather than dying without a JSON line.
    headline = 0.0
    for n_try in (1440000, 960000, 480000, 48000):
        try:
            headline = bench_config(f"subtractive x1024 x{n_try // 48000}s",
                                    subtractive_voice(cfg), n_try, 1024)
            break
        except Exception as e:
            log(f"[headline n={n_try}] failed: {e!r}")

    # secondary configs (stderr only); failures must not kill the headline.
    # Each config starts at a 30 s render.  Block-engine configs whose
    # whole-render [V, n] lanes would not fit device memory at 30 s run
    # device-side
    # segmented (render(..., segment=): one dispatch, lax.scan over
    # segments with carried state, live intermediates bounded to one
    # segment -- compiler._make_segmented); the ladder then degrades the
    # segment before it ever shortens the render.
    for name, patch, ns, v in (
        ("sine x1024", sine_patch(cfg), ((1440000, None), (480000, None)),
         1024),
        # [16384, 1, 192000] f32 output = 12.6 GB -- the ladder degrades
        # to 2 s if that does not fit
        ("farm x16384", subtractive_voice(cfg),
         ((192000, None), (96000, None)), 16384),
        # the patch is fully serial (cross-FM + filter feedback)
        ("feedback x1024", feedback_patch(cfg),
         ((1440000, None), (480000, None)), 1024),
        # sequencers are register-safe select trees -> the shell
        ("sequencer x1024 (fused)", sequencer_patch(cfg),
         ((1440000, None), (480000, None)), 1024),
        # sample playback keeps this on the block engine (waveform reads)
        ("drums x1024 (block engine)", drum_machine(cfg),
         ((1440000, 480000), (1440000, 240000), (480000, None)), 1024),
        # real-length samples: three 48,000-frame waveforms read by XLA
        # gathers (modules/sample.py block impl)
        ("sampler x1024 (48k-frame samples)", sampler_kit(cfg),
         ((1440000, 480000), (1440000, 240000), (480000, None)), 1024),
        # Freeverb's 12 delay lines per channel: the XLA chunked
        # comb/allpass solve (modules/freeverb.py block impl)
        ("reverb x1024 (block engine)", reverb_patch(cfg),
         ((1440000, 288000), (1440000, 480000), (480000, None)), 1024),
    ):
        for n_try, seg in ns:
            seg_tag = f" seg={seg // 48000}s" if seg else ""
            try:
                bench_config(f"{name} x{n_try // 48000}s{seg_tag}", patch,
                             n_try, v, segment=seg)
                break
            except Exception as e:
                log(f"[{name} n={n_try} seg={seg}] failed: {e!r}")

    # training-step benchmark (stderr): the shell's fwd+bwd gradient step
    try:
        import optax
        from srack_tpu.utils.train import SoundMatcher, batched_train_step
        patch = subtractive_voice(cfg)
        compiled = st.compile_patch(patch)
        v, nt = 1024, 48000
        sm = SoundMatcher(patch, nt)
        ts = sm.init()
        step = jax.jit(batched_train_step(compiled, optax.adam(1e-3), nt,
                                          fast=True))
        targets = jnp.zeros((v, cfg.channels, nt), jnp.float32)
        keys = jax.random.split(jax.random.PRNGKey(2), v)
        t0 = time.perf_counter()
        tr, opt, loss = step(ts["train"], ts["frozen"],
                             optax.adam(1e-3).init(ts["train"]),
                             targets, keys)
        l0 = float(loss)
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            tr, opt, loss = step(tr, ts["frozen"], opt, targets, keys)
            l0 = float(loss)
            best = min(best, time.perf_counter() - t0)
        log(f"[train x{v} (shell fwd+bwd)] grad step {best * 1e3:.0f}ms "
            f"({v * nt / best / 1e9:.2f}G samples/s through fwd+bwd, "
            f"compile {compile_s:.0f}s, loss {l0:.4f})")

        # production-shaped measurement: K steps per dispatch (a real
        # training loop scans steps, with no host round trip between them)
        from srack_tpu.utils.train import multi_train_step
        K = 32
        mstep = jax.jit(multi_train_step(compiled, optax.adam(1e-3), nt, K,
                                         fast=True))
        t0 = time.perf_counter()
        tr2, opt2, losses = mstep(ts["train"], ts["frozen"],
                                  optax.adam(1e-3).init(ts["train"]),
                                  targets, keys)
        lK = float(losses[-1])
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            tr2, opt2, losses = mstep(tr2, ts["frozen"], opt2, targets, keys)
            lK = float(losses[-1])
            best = min(best, time.perf_counter() - t0)
        per = best / K
        log(f"[train x{v} ({K}-step scan)] {per * 1e3:.1f}ms/step "
            f"({v * nt / per / 1e9:.2f}G samples/s through fwd+bwd, "
            f"compile {compile_s:.0f}s, loss {lK:.4f})")
        RECAP.append(f"train {K}-step: {per * 1e3:.1f}ms/step "
                     f"({v * nt / per / 1e9:.2f}G fwd+bwd)")
    except Exception as e:
        log(f"[train] failed: {e!r}")

    # exact-mode rate (stderr): the oracle-fidelity precision ("exact" =
    # f64 phase/reverb mirroring the reference's per-module dtypes,
    # matching oracle.py ~1e-6) has a stated rate, not just fast mode.
    # x64 is enabled HERE, after every fast-mode config has run: fast
    # mode must trace without x64 (conftest forces it only for tests).
    try:
        jax.config.update("jax_enable_x64", True)
        cfg_x = st.AudioConfig(sample_rate=48000, block_size=1024,
                               channels=1, precision="exact")
        # segment= rungs first: device-side segmentation
        # (compiler._make_segmented) bounds the 10 s render's live
        # intermediates
        for n_try, seg in ((480000, 96000), (480000, 48000),
                           (96000, None), (48000, None)):
            seg_tag = f" seg={seg // 48000}s" if seg else ""
            try:
                bench_config(
                    f"exact x1024 (block engine) "
                    f"x{n_try / 48000:g}s{seg_tag}",
                    subtractive_voice(cfg_x), n_try, 1024, engine="block",
                    segment=seg)
                break
            except Exception as e:
                log(f"[exact n={n_try}] failed: {e!r}")
    except Exception as e:
        log(f"[exact] failed: {e!r}")

    # compact recap: every config's rate in the driver-captured tail
    log("=== recap (all configs) ===")
    for line in RECAP:
        log("  " + line)
    print(json.dumps({
        "metric": "rendered_audio_samples_per_sec_per_chip",
        "value": headline,
        "unit": "samples/s",
        "vs_baseline": headline / BASELINE_SAMPLES_PER_SEC,
    }), flush=True)


if __name__ == "__main__":
    main()
