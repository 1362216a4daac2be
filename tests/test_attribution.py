"""Pins for the per-sample op weights (docs/SEQUENCER_BOUND.md).

The traced per-sample issue-op counts of the bench patches (the exact step
body the voice-kernel shell unrolls) are the machine-checkable measure of
how much work each patch asks for per sample: module-step edits that
change the op weight show up as failures here, and the doc's ratios stay
tied to checked numbers.  Device times per sample come from the card, not
from this test.
"""

from collections import Counter

import jax
import jax.extend

import srack_tpu as st
from srack_tpu.presets import (feedback_patch, sequencer_patch, sine_patch,
                               subtractive_voice)

# layout/metadata-only primitives (no arithmetic of their own)
FREE = {
    "broadcast_in_dim", "reshape", "squeeze", "convert_element_type",
    "stop_gradient", "transpose",
}

CFG = st.AudioConfig(sample_rate=48000, block_size=1024, channels=1,
                     precision="fast")


def traced_issue_ops(patch) -> int:
    compiled = st.compile_patch(patch)
    params = compiled.derived_params(patch.params())
    state = compiled.init_state()
    key = jax.random.PRNGKey(0)
    xs = compiled._make_xs(patch.params(), key, 1, drivers={})
    x_t = {m: a[0] for m, a in xs.items()}

    def step(params, st_, fb, x_t):
        ns, fb_o, audio, _ = compiled._sample_step(
            params, st_["states"], st_["fb"], x_t, nograd=True)
        return {"states": ns, "fb": fb_o}, audio

    jaxpr = jax.make_jaxpr(step)(params, state, state["fb"], x_t)
    counts = Counter()

    def walk(jx):
        for eqn in jx.eqns:
            counts[eqn.primitive.name] += 1
            for sub in eqn.params.values():
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    walk(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    walk(sub)

    walk(jaxpr.jaxpr)
    return sum(c for p, c in counts.items() if p not in FREE)


# Bands around the traced counts (sine 43, subtractive 356, feedback 214,
# sequencer 2094).  A drop below the band means work was deleted (update
# the doc); a rise above means a module step got heavier (time the patch
# on the card before accepting).
BANDS = {
    "sine": (30, 60),
    "subtractive": (280, 420),
    "feedback": (160, 260),
    "sequencer": (1700, 2500),
}


def test_traced_op_counts_in_band():
    got = {
        "sine": traced_issue_ops(sine_patch(CFG)),
        "subtractive": traced_issue_ops(subtractive_voice(CFG)),
        "feedback": traced_issue_ops(feedback_patch(CFG)),
        "sequencer": traced_issue_ops(sequencer_patch(CFG)),
    }
    for name, n in got.items():
        lo, hi = BANDS[name]
        assert lo <= n <= hi, (
            f"{name} traces {n} issue-ops/sample, outside the pinned "
            f"[{lo}, {hi}] band -- update docs/SEQUENCER_BOUND.md and "
            f"time the patch on the card before accepting")

