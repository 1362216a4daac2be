"""Preset patches: the five BASELINE benchmark configurations.

These are the framework's "model zoo" -- self-contained patches (no external
drivers) exercising every part of the engine, matching BASELINE.md:

1. :func:`sine_patch`       -- single VCO -> Output sine, mono.
2. :func:`subtractive_voice`-- VCO -> Moog LP -> VCA with ADSR + LFO pitch
   mod; gate from a slow square-wave oscillator (the reference has no
   dedicated LFO/clock module -- a low-frequency square oscillator *is* the
   clock idiom, SURVEY.md §7 step 4).
3. :func:`sequencer_patch`  -- clock + sequencers driving an 8-voice
   polyphonic subtractive synth.
4. :func:`feedback_patch`   -- cross-FM oscillator pair + filter feedback.
5. :func:`farm_params`      -- randomized parameter stacks over the
   subtractive-voice topology for batch dataset rendering.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .config import AudioConfig
from .engine import stack_params
from .patch import Patch


def sine_patch(cfg: AudioConfig | None = None) -> Patch:
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    osc = p.add("Oscillator", val=0.0, name="vco")
    p.connect(osc, "Sine", p.output, 0)
    return p


def subtractive_voice(cfg: AudioConfig | None = None, *,
                      note: float = -1.0, gate_rate_oct: float = -5.5,
                      lfo_oct: float = -7.0, lfo_depth: float = 0.02,
                      cutoff: float = 0.35, res: float = 0.4) -> Patch:
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    lfo = p.add("Oscillator", val=lfo_oct, name="lfo")
    depth = p.add("Multiply", constant=lfo_depth, name="lfo_depth")
    osc = p.add("Oscillator", val=note, name="vco")
    flt = p.add("Moog Filter", freq=cutoff, res=res, name="vcf")
    # the clock square only feeds gate edge detection -- band-limiting is
    # irrelevant there, and polyBLEP is ~25% of the voice's per-sample ops
    gate_clk = p.add("Oscillator", val=gate_rate_oct, name="gate_clock",
                     antialiasing=False)
    env = p.add("ADSR", a_sec=0.01, d_sec=0.08, s_val=0.5, r_sec=0.15,
                name="env")
    vca = p.add("VCA", name="vca")
    p.connect(lfo, "Sine", depth, "In1")
    p.connect(depth, 0, osc, "CV")
    p.connect(osc, "Sawtooth", flt, "Audio")
    p.connect(gate_clk, "Square", env, "Gate")
    p.connect(flt, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(vca, 0, p.output, 1)
    return p


def gate_cv_voice(cfg: AudioConfig | None = None, *, cutoff: float = 0.5,
                  res: float = 0.3, a: float = 0.01, d: float = 0.1,
                  s: float = 0.6, r: float = 0.2, wave: str = "Sawtooth"):
    """Subtractive voice driven by external gate + pitch-CV Inputs.

    The playable counterpart of :func:`subtractive_voice` (which carries
    its own clock): bind driver lanes from ``utils.notes.note_track`` /
    ``io.read_midi`` to the returned handles.  Returns
    ``(patch, gate_input, cv_input)``.
    """
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    gate = p.add("Input", name="gate")
    cv = p.add("Input", name="cv")
    osc = p.add("Oscillator", name="osc")
    flt = p.add("Moog Filter", freq=cutoff, res=res)
    env = p.add("ADSR", a_sec=a, d_sec=d, s_val=s, r_sec=r)
    vca = p.add("VCA")
    p.connect(cv, 0, osc, "CV")
    p.connect(gate, 0, env, "Gate")
    p.connect(osc, wave, flt, "Audio")
    p.connect(flt, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(vca, 0, p.output, 1)
    return p, gate, cv


def sequencer_patch(cfg: AudioConfig | None = None) -> Patch:
    """Clock + grid/pattern sequencers driving 8 subtractive voices."""
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    clk = p.add("Oscillator", val=-5.0, name="clock")  # ~13.75 Hz square

    # melodic voice from the grid sequencer
    seq = [(i * 3 % 24, i % 3 != 0) for i in range(16)]
    grid = p.add("Grid Sequencer", sequence=seq, n_steps=16, name="grid")
    p.connect(clk, "Square", grid, "Step")

    lead_osc = p.add("Oscillator", val=-2.0, name="lead_vco")
    p.connect(grid, "CV", lead_osc, "CV")
    lead_env = p.add("ADSR", a_sec=0.005, d_sec=0.1, s_val=0.3, r_sec=0.05,
                     name="lead_env")
    p.connect(grid, "Gate", lead_env, "Gate")
    lead_flt = p.add("Moog Filter", freq=0.4, res=0.5, name="lead_vcf")
    p.connect(lead_osc, "Sawtooth", lead_flt, "Audio")
    lead_vca = p.add("VCA", name="lead_vca")
    p.connect(lead_flt, 0, lead_vca, "Audio")
    p.connect(lead_env, 0, lead_vca, "CV")

    # 7 percussive voices from the pattern sequencer rows
    pattern = [[(True if (s % (r + 2) == 0) else None) for s in range(16)]
               for r in range(8)]
    pat = p.add("Pattern Sequencer", pattern=pattern, n_steps=16, name="pat")
    p.connect(clk, "Square", pat, "Step")
    p.connect(grid, "Sync", pat, "Sync")

    # 4 voices per sub-mix at 0.25 each keeps every bus within full scale
    mixers = [p.add("Mono Mixer", gains=(0.25, 0.25, 0.25, 0.25),
                    name=f"mix{i}") for i in range(2)]
    p.connect(lead_vca, 0, mixers[0], 0)
    for r in range(7):
        osc = p.add("Oscillator", val=-3.0 + r * 0.5, name=f"perc_vco{r}")
        env = p.add("ADSR", a_sec=0.001, d_sec=0.05, s_val=0.0, r_sec=0.02,
                    name=f"perc_env{r}")
        vca = p.add("VCA", name=f"perc_vca{r}")
        p.connect(pat, str(r), env, "Gate")
        p.connect(osc, "Square" if r % 2 else "Sine", vca, "Audio")
        p.connect(env, 0, vca, "CV")
        p.connect(vca, 0, mixers[(r + 1) // 4], (r + 1) % 4)
    final = p.add("Mono Mixer", gains=(0.5, 0.5, 0.0, 0.0), name="final_mix")
    p.connect(mixers[0], 0, final, 0)
    p.connect(mixers[1], 0, final, 1)
    p.connect(final, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(final, 0, p.output, 1)
    return p


def feedback_patch(cfg: AudioConfig | None = None) -> Patch:
    """Cross-FM oscillator pair + filter feedback loop (BASELINE config 4)."""
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    a = p.add("Oscillator", val=-2.0, name="fm_a")
    b = p.add("Oscillator", val=-2.5, name="fm_b")
    sa = p.add("Multiply", constant=0.7, name="fm_a_amt")
    sb = p.add("Multiply", constant=0.9, name="fm_b_amt")
    p.connect(a, "Sine", sa, "In1")
    p.connect(sa, 0, b, "CV")
    p.connect(b, "Sine", sb, "In1")
    p.connect(sb, 0, a, "CV")

    mix = p.add("Mono Mixer", gains=(1.0, 0.4, 0.0, 0.0), name="fb_mix")
    flt = p.add("Moog Filter", freq=0.45, res=0.55, name="fb_vcf")
    p.connect(a, "Sine", mix, 0)
    p.connect(flt, 0, mix, 1)        # filter feedback loop
    p.connect(mix, 0, flt, "Audio")
    p.connect(flt, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(flt, 1, p.output, 1)
    return p


def reverb_patch(cfg: AudioConfig | None = None) -> Patch:
    """Subtractive voice into Freeverb (stereo) -- exercises delay lines.

    Freeverb's 8 feedback combs sum coherently at room_size 0.7 (~6x gain
    on sustained input); wet/dry are set for the worst-case farm voice
    (randomized cutoff/resonance) to stay inside full scale."""
    cfg = cfg or AudioConfig(channels=2)
    p = subtractive_voice(cfg)
    vca = next(i for i in p if i.name == "vca")
    rev = p.add("Freeverb", room_size=0.7, dampening=0.4, wet=0.12, dry=0.3,
                name="verb")
    p.connect(p.handle(vca.id), 0, rev, "Left")
    p.connect(p.handle(vca.id), 0, rev, "Right")
    p.connect(rev, "Left", p.output, 0)
    if cfg.channels > 1:
        p.connect(rev, "Right", p.output, 1)
    return p


def farm_params(patch: Patch, n_voices: int, seed: int = 0) -> dict:
    """Randomized per-voice parameter stacks for the render farm
    (BASELINE config 5): random notes, cutoffs, resonances, envelope times
    over a shared topology."""
    rng = np.random.default_rng(seed)
    base = patch.params()
    out = []
    for _ in range(n_voices):
        params = jax.tree.map(lambda a: a, base)
        for inst in patch:
            pd = params[inst.id]
            t = inst.mdef.type_name
            # clocks keep the patch tempo: the farm story is random
            # *notes/cutoffs/envelopes* over a shared topology (BASELINE
            # config 5), not per-voice tempos.  The old exclusion matched
            # only subtractive_voice's "gate_clock", so the kit/sequencer
            # "clock" oscillators got +-1-octave random tempos -- which
            # also scattered every voice's trigger positions.
            if t == "Oscillator" and "clock" not in (inst.name or ""):
                pd["val"] = jnp.float32(pd["val"] + rng.uniform(-1.0, 1.0))
            elif t == "Moog Filter":
                pd["freq"] = jnp.float32(rng.uniform(0.1, 0.8))
                pd["res"] = jnp.float32(rng.uniform(0.0, 0.9))
            elif t == "ADSR":
                pd["a_sec"] = jnp.float32(rng.uniform(0.001, 0.1))
                pd["d_sec"] = jnp.float32(rng.uniform(0.01, 0.3))
                pd["s_val"] = jnp.float32(rng.uniform(0.1, 0.9))
                pd["r_sec"] = jnp.float32(rng.uniform(0.01, 0.3))
        out.append(params)
    return stack_params(out)


def drum_machine(cfg: AudioConfig | None = None) -> Patch:
    """Noise/sample percussion kit driven by a pattern sequencer --
    exercises Noise, Sample, Pattern Sequencer and the filter as a
    resonant drum body."""
    cfg = cfg or AudioConfig(channels=1)
    p = Patch(cfg)
    clk = p.add("Oscillator", val=-4.5, name="clock")
    pat = p.add("Pattern Sequencer", n_steps=16, name="pat",
                pattern=[
                    [True, None, None, None] * 4,            # kick
                    [None, None, True, None] * 4,            # snare
                    [True, True, False, True] * 4,           # hats
                ])
    p.connect(clk, "Square", pat, "Step")

    # kick: short decaying click through a low resonant filter
    kick_env = p.add("ADSR", a_sec=0.001, d_sec=0.12, s_val=0.0,
                     r_sec=0.05, name="kick_env")
    kick_osc = p.add("Oscillator", val=-3.5, name="kick_osc")
    kick_vca = p.add("VCA", name="kick_vca")
    p.connect(pat, "0", kick_env, "Gate")
    p.connect(kick_osc, "Sine", kick_vca, "Audio")
    p.connect(kick_env, 0, kick_vca, "CV")

    # snare: filtered noise burst
    noise = p.add("Noise", name="noise")
    sn_env = p.add("ADSR", a_sec=0.001, d_sec=0.08, s_val=0.0,
                   r_sec=0.03, name="snare_env")
    sn_flt = p.add("Moog Filter", freq=0.6, res=0.3, name="snare_flt")
    sn_vca = p.add("VCA", name="snare_vca")
    p.connect(noise, 0, sn_flt, "Audio")
    p.connect(pat, "1", sn_env, "Gate")
    p.connect(sn_flt, 1, sn_vca, "Audio")  # bandpass
    p.connect(sn_env, 0, sn_vca, "CV")

    # hats: a short looped sample (synthesised metallic waveform)
    t = np.linspace(0, 1, 400)
    metallic = (np.sin(2 * np.pi * 317 * t) * np.sin(2 * np.pi * 1021 * t)
                * np.exp(-10 * t)).astype(np.float32)
    hat = p.add("Sample", samples=metallic,
                wav_sample_rate=cfg.sample_rate, name="hat")
    p.connect(pat, "2", hat, "Gate")

    # bus peaks: kick ~0.96, hats ~0.81 (deterministic); the snare bus is
    # NOISE through a resonant filter -- its peak grows with render length
    # (measured ~1.13 over 10 s but ~1.4 over 30 s of re-keyed segments,
    # which pushed the old 0.45/0.3/0.25 mix to 1.06).  Gains budget the
    # worst-case sum at the long-render snare peak:
    # 0.36*0.96 + 0.22*1.4 + 0.2*0.81 = 0.82, leaving margin for rarer
    # noise draws
    mix = p.add("Mono Mixer", gains=(0.36, 0.22, 0.2, 0.0), name="mix")
    p.connect(kick_vca, 0, mix, 0)
    p.connect(sn_vca, 0, mix, 1)
    p.connect(hat, 0, mix, 2)
    p.connect(mix, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(mix, 0, p.output, 1)
    return p


def sampler_kit(cfg: AudioConfig | None = None) -> Patch:
    """Drum kit from REAL-LENGTH samples: every hit is a Sample module
    playing a full-second (sample_rate-frame) waveform at pitch CV 0
    (rate 1.0, sample.rs:233-234 law).  This is the sample-playback
    workload the synthesized 400-frame hat of :func:`drum_machine`
    sidesteps -- table reads are XLA gathers from 48,000-frame tables
    instead of a small table.
    """
    cfg = cfg or AudioConfig()
    sr = cfg.sample_rate
    p = Patch(cfg)
    clk = p.add("Oscillator", val=-4.5, name="clock")
    pat = p.add("Pattern Sequencer", n_steps=16, name="pat",
                pattern=[
                    [True, None, None, None] * 4,            # kick
                    [None, None, True, None] * 4,            # snare
                    [True, True, False, True] * 4,           # hats
                ])
    p.connect(clk, "Square", pat, "Step")

    t = np.arange(sr, dtype=np.float64) / sr                 # 1 s of frames
    rng = np.random.default_rng(7)
    kick_wave = (np.sin(2 * np.pi * (45.0 + 85.0 * np.exp(-18.0 * t)) * t)
                 * np.exp(-6.0 * t)).astype(np.float32)
    snare_wave = (rng.uniform(-1.0, 1.0, sr)
                  * np.exp(-22.0 * t)).astype(np.float32)
    hat_wave = (rng.uniform(-1.0, 1.0, sr) * np.exp(-55.0 * t)
                * np.sin(2 * np.pi * 5900.0 * t)).astype(np.float32)

    mix = p.add("Mono Mixer", gains=(0.5, 0.3, 0.2, 0.0), name="mix")
    for row, (name, wave) in enumerate(
            (("kick", kick_wave), ("snare", snare_wave), ("hat", hat_wave))):
        smp = p.add("Sample", samples=wave, wav_sample_rate=sr, name=name)
        p.connect(pat, str(row), smp, "Gate")
        p.connect(smp, 0, mix, row)
    p.connect(mix, 0, p.output, 0)
    if cfg.channels > 1:
        p.connect(mix, 0, p.output, 1)
    return p


PRESETS = {
    "sine": sine_patch,
    "subtractive": subtractive_voice,
    "sequencer": sequencer_patch,
    "feedback": feedback_patch,
    "reverb": reverb_patch,
    "drums": drum_machine,
    "sampler": sampler_kit,
}
