#!/usr/bin/env python
"""Kernel-speed batched sound matching.

Fits shared subtractive-voice parameters against a batch of target renders
using the voice-kernel shell's forward+backward kernels (``fast=True``,
taken where the platform compiles the shell -- an NVIDIA GPU): a gradient
step through 1,024 voices x 1 s of 48 kHz audio took 84 ms on an H100 80GB
HBM3 (700 W power limit).

Usage: python examples/train_fast.py [steps] [voices]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import optax

import srack_tpu as st
from srack_tpu import route
from srack_tpu.presets import subtractive_voice
from srack_tpu.utils.train import SoundMatcher, batched_train_step


def main(argv):
    steps = int(argv[1]) if len(argv) > 1 else 20
    v = int(argv[2]) if len(argv) > 2 else 1024
    cfg = st.AudioConfig(sample_rate=48000, channels=1, precision="fast")
    n = 48000

    # mystery target: a brighter, more resonant voice
    target_patch = subtractive_voice(cfg, cutoff=0.6, res=0.7, note=-0.5)
    tc = st.compile_patch(target_patch)
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    tparams = st.replicate_params(tc.default_params, v)
    tstate = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                          tc.init_state())
    targets, _, _ = tc.render(n, params=tparams, state=tstate, key=keys,
                              batched=True)

    patch = subtractive_voice(cfg)
    compiled = st.compile_patch(patch)
    sm = SoundMatcher(patch, n)
    ts = sm.init()
    opt = optax.adam(1e-2)
    fast = route.voice_kernel()
    step = jax.jit(batched_train_step(compiled, opt, n, fast=fast))

    import time
    train, opt_state = ts["train"], opt.init(ts["train"])
    for i in range(steps):
        t0 = time.perf_counter()
        train, opt_state, loss = step(train, ts["frozen"], opt_state,
                                      targets, keys)
        l = float(loss)
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {l:.5f}  "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms/step, "
                  f"fast={fast})")
    fitted = SoundMatcher._merge(train, ts["frozen"])
    vcf = [i.id for i in patch if i.name == "vcf"][0]
    print("fitted cutoff:", float(fitted[vcf]["freq"]), "(target 0.6)")
    print("fitted res:   ", float(fitted[vcf]["res"]), "(target 0.7)")


if __name__ == "__main__":
    main(sys.argv)
