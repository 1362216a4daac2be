#!/usr/bin/env python
"""Minimal batch render service: patches in, WAV out, over HTTP.

The production-serving shape for this framework: one process owns the GPU,
keeps compiled programs warm (the compile cache is keyed by patch
topology, so repeated requests for the same topology pay zero compiles),
and renders request batches with the fused engines.  Stdlib-only
(http.server) so it runs anywhere the library does.

POST /render with a JSON body:
    {
      "preset": "subtractive" | "sine" | "sequencer" | "feedback" |
                "reverb" | "drums",
      "seconds": 2.0,            # render length
      "voices": 1,               # >1 renders a randomized farm batch
      "params": {"vco": {"val": -1.0}},   # optional per-module overrides
      "seed": 0
    }
Response: audio/wav (voices > 1: the voices are mixed down equally).

Run:  python examples/render_service.py [port]
Try:  curl -s -X POST localhost:8765/render \\
        -d '{"preset": "drums", "seconds": 2}' > out.wav
"""

import io
import json
import pathlib
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import srack_tpu as st
from srack_tpu.presets import PRESETS, farm_params

CFG = st.AudioConfig(sample_rate=48000, block_size=1024, channels=1,
                     precision="fast")
# one device, many threads: serialize renders (JAX dispatch is thread-safe
# but interleaved big renders would just contend for HBM)
_LOCK = threading.Lock()


def render_request(req: dict) -> bytes:
    preset = req.get("preset", "subtractive")
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; "
                         f"have {sorted(PRESETS)}")
    seconds = float(req.get("seconds", 1.0))
    n = max(1, int(seconds * CFG.sample_rate))
    voices = int(req.get("voices", 1))
    patch = PRESETS[preset](CFG)
    for mod_name, overrides in (req.get("params") or {}).items():
        inst = next((i for i in patch if i.name == mod_name), None)
        if inst is None:
            raise ValueError(f"no module named {mod_name!r}")
        patch.set_params(patch.handle(inst.id), **overrides)

    with _LOCK:
        t0 = time.perf_counter()
        if voices > 1:
            params = farm_params(patch, voices,
                                 seed=int(req.get("seed", 0)))
            audio, _, _ = st.render_batch(patch, n, params=params,
                                          key=int(req.get("seed", 0)))
            mono = jnp.mean(audio[:, 0, :], axis=0)
        else:
            audio, _, _ = st.render(patch, n, key=int(req.get("seed", 0)))
            mono = audio[0]
        wall = time.perf_counter() - t0

    data = np.asarray(mono, np.float32)
    rate = n * max(voices, 1) / wall
    print(f"[render] {preset} n={n} voices={voices} wall={wall * 1e3:.0f}ms"
          f" ({rate / 1e6:.0f} M samples/s)", flush=True)
    buf = io.BytesIO()
    from srack_tpu.io.wav import write_wav
    write_wav(buf, data[None], CFG.sample_rate)
    return buf.getvalue()


class Handler(BaseHTTPRequestHandler):
    def do_POST(self):
        if self.path != "/render":
            self.send_error(404)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            wav = render_request(req)
        except Exception as e:  # report, don't crash the server
            self.send_response(400)
            self.send_header("Content-Type", "text/plain")
            self.end_headers()
            self.wfile.write(f"{type(e).__name__}: {e}\n".encode())
            return
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(wav)))
        self.end_headers()
        self.wfile.write(wav)

    def log_message(self, *a):  # quiet default access log
        pass


def main(argv):
    port = int(argv[1]) if len(argv) > 1 else 8765
    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"render service on http://127.0.0.1:{port}/render "
          f"(device: {jax.devices()[0].platform})", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main(sys.argv)
