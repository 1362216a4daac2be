"""Kernel routes (srack_tpu/route.py) and the compile-cache location.

The route is decided in one place: the voice-kernel shell where the
platform compiles it (a GPU), plain XLA elsewhere, and the Pallas
interpreter only when a caller asks for it.
"""

import os

import jax
import pytest

import srack_tpu as st
from srack_tpu import presets, route
from srack_tpu.utils import compile_cache

CFG = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                     precision="fast")


def test_cpu_has_no_voice_kernel():
    assert jax.default_backend() == "cpu"
    assert not route.voice_kernel()


@pytest.mark.parametrize("name", ["subtractive", "drums"])
def test_fused_off_gpu_raises(name):
    """engine="fused" never falls back to the interpreter."""
    patch = presets.PRESETS[name](CFG)
    compiled = st.compile_patch(patch)
    params = presets.farm_params(patch, 2)
    with pytest.raises(ValueError):
        compiled.render(16, params=params, batched=True, engine="fused")


def test_fused_eligible_patch_raises_for_the_platform():
    patch = presets.subtractive_voice(CFG)
    compiled = st.compile_patch(patch)
    assert compiled.fused_eligible()
    with pytest.raises(ValueError, match="NVIDIA"):
        compiled._build_fn(16, True, "fused")


@pytest.mark.parametrize("name,gpu,batched,want", [
    ("subtractive", False, True, "block"),
    ("subtractive", False, False, "scan"),
    ("subtractive", True, True, "fused"),
    ("subtractive", True, False, "block"),
    ("sequencer", True, True, "fused"),
    ("drums", True, True, "block"),
    ("reverb", False, True, "block"),
])
def test_auto_engine_follows_route(monkeypatch, name, gpu, batched, want):
    monkeypatch.setattr(route, "voice_kernel", lambda: gpu)
    compiled = st.compile_patch(presets.PRESETS[name](CFG))
    assert compiled.auto_engine(batched=batched) == want


def test_exact_mode_never_fused(monkeypatch):
    monkeypatch.setattr(route, "voice_kernel", lambda: True)
    cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                         precision="exact")
    compiled = st.compile_patch(presets.subtractive_voice(cfg))
    assert compiled.auto_engine(batched=True) == "block"


@pytest.mark.parametrize("gpu", [False, True])
def test_block_serial_stage_route(monkeypatch, gpu):
    monkeypatch.setattr(route, "voice_kernel", lambda: gpu)
    prog = st.compile_patch(presets.drum_machine(CFG)).block_program()
    assert prog._use_shell(False) is gpu
    assert prog._use_shell(True)  # the tests' interpret mode


def test_grad_render_off_gpu_is_scan_autodiff():
    """Off the GPU grad_render_fn wraps the scan engine: same audio."""
    import numpy as np

    patch = presets.subtractive_voice(CFG)
    compiled = st.compile_patch(patch)
    v, n = 2, 24
    params = presets.farm_params(patch, v)
    state = jax.tree.map(lambda a: jax.numpy.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    a, _, _ = compiled.grad_render_fn(n)(params, state, keys, {})
    b, _, _ = compiled.make_render_fn(n, batched=True)(params, state, keys,
                                                        {})
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- compile cache -----------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    # set by JAX from the environment, never overridden in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_ignored_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split(), "the cache is git-ignored"
