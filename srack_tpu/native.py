"""ctypes bindings for the native (C++) runtime components.

The reference's entire runtime is native (Rust); here the accelerator compute path
is JAX/XLA/Pallas and the *host-side* runtime pieces -- the execution
planner and the audio I/O codecs -- have C++ implementations
(native/planner.cpp, native/wav.cpp) used when available, with pure-Python
fallbacks (planner.py, io/wav.py).  The library is compiled on first use
with g++ into ``srack_tpu/_native/`` and cached; tests assert native and
Python planners agree on randomized graphs.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_PKG_DIR = pathlib.Path(__file__).parent
_SRC_DIR = _PKG_DIR.parent / "native"
_OUT_DIR = _PKG_DIR / "_native"
_SOURCES = ("planner.cpp", "wav.cpp")


def _build() -> pathlib.Path | None:
    sources = [_SRC_DIR / s for s in _SOURCES]
    if not all(s.exists() for s in sources):
        return None
    _OUT_DIR.mkdir(exist_ok=True)
    out = _OUT_DIR / "libsrack_native.so"
    newest_src = max(s.stat().st_mtime for s in sources)
    if out.exists() and out.stat().st_mtime >= newest_src:
        return out
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           *[str(s) for s in sources], "-o", str(out)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        return None
    return out


def lib():
    """The loaded native library, or None (pure-Python fallbacks apply)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SRACK_TPU_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        L = ctypes.CDLL(str(path))
        L.srack_plan_execution.restype = ctypes.c_int
        L.srack_plan_execution.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        L.srack_wav_decode.restype = ctypes.c_int
        L.srack_wav_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
        L.srack_interleave_i16.restype = None
        L.srack_interleave_i16.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int16)]
        _LIB = L
    except OSError:
        _LIB = None
    return _LIB


def plan_execution_native(module_ids, deps_by_module, output_id):
    """Native planner over id lists.  Returns (plan_ids, broken_pairs) or
    None when the native library is unavailable."""
    L = lib()
    if L is None:
        return None
    idx = {mid: i for i, mid in enumerate(module_ids)}
    n = len(module_ids)
    offsets = np.zeros(n + 1, dtype=np.int32)
    flat = []
    for i, mid in enumerate(module_ids):
        for d in deps_by_module[mid]:
            flat.append(idx[d])
        offsets[i + 1] = len(flat)
    deps = np.asarray(flat, dtype=np.int32)
    plan = np.zeros(n, dtype=np.int32)
    max_broken = max(16, len(flat))
    broken = np.zeros(2 * max_broken, dtype=np.int32)
    n_broken = ctypes.c_int(0)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    emitted = L.srack_plan_execution(
        n, idx[output_id], ptr(offsets),
        ptr(deps) if len(deps) else ptr(np.zeros(1, dtype=np.int32)),
        ptr(plan), ptr(broken), max_broken, ctypes.byref(n_broken))
    if emitted != n:
        return None  # overflow or stall: fall back to Python
    plan_ids = [module_ids[i] for i in plan]
    broken_pairs = {
        (module_ids[broken[2 * k]], module_ids[broken[2 * k + 1]])
        for k in range(n_broken.value)}
    return plan_ids, broken_pairs


def wav_decode_native(data: bytes):
    """Native WAV decode -> (samples_f32, sample_rate) or None."""
    L = lib()
    if L is None:
        return None
    n = ctypes.c_int64(0)
    sr = ctypes.c_int32(0)
    rc = L.srack_wav_decode(data, len(data), None, ctypes.byref(n),
                            ctypes.byref(sr))
    if rc != 0:
        return None
    out = np.zeros(n.value, dtype=np.float32)
    rc = L.srack_wav_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        return None
    return out[:n.value], int(sr.value)


def interleave_i16(planar: np.ndarray) -> np.ndarray:
    """[channels, n] f32 -> interleaved int16 PCM (native when available)."""
    planar = np.ascontiguousarray(planar, dtype=np.float32)
    c, n = planar.shape
    L = lib()
    if L is None:
        pcm = np.clip(np.round(planar * 32767.0), -32768, 32767)
        return pcm.T.reshape(-1).astype(np.int16)
    out = np.zeros(c * n, dtype=np.int16)
    L.srack_interleave_i16(
        planar.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), c, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return out
