"""Test configuration.

Tests run on CPU with 8 virtual devices (multi-device sharding paths are
validated on a host mesh; the compiled GPU kernels run in chip_smoke.py on
the card, and tests marked ``gpu`` are skipped here), and with x64 enabled so the ``exact`` precision mode can mirror the reference's
f64 oscillator phase / f64 freeverb core.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.default_backend() == "cpu"


import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    skip = pytest.mark.skip(reason="needs an NVIDIA GPU: the voice-kernel "
                            "shell has no compiled CPU form")
    for item in items:
        if "gpu" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True, scope="module")
def _drop_jit_mappings_between_modules():
    """Free compiled executables after each test module.

    Every jitted program the suite compiles holds LLVM JIT code pages; one
    process running the full suite accumulates >65k mmap regions and the
    CPU client segfaults when it hits the kernel's vm.max_map_count
    (default 65530).  Dropping the jit caches lets the loaded executables
    (and their code mappings) be garbage-collected; cross-module cache
    hits are rare, so this costs little recompilation.
    """
    yield
    import gc

    jax.clear_caches()
    try:
        from srack_tpu import compiler as _compiler

        _compiler._COMPILE_CACHE.clear()
    except Exception:
        pass
    gc.collect()
