"""The voice-kernel shell (ops/shell.py) on the CPU.

Two kinds of check, both without a GPU:

* the shell's Pallas kernels in interpret mode against the scan engine --
  the whole-patch render for every fused-eligible preset, buffer feedback,
  the block engine's serial stage and the backward kernel's gradients;
* the same programs lowered for CUDA (``lower(lowering_platforms=
  ("cuda",))`` works on a CPU-only host): a primitive the Triton route has
  no rule for (``slice``, a wide ``concatenate``) fails here, not only on
  the card.

Small shapes only (interpret mode is slow); full-size validation on the
card runs in chip_smoke.py.
"""

import numpy as np
import jax
import pytest
import jax.numpy as jnp

import srack_tpu as st
from srack_tpu import presets
from srack_tpu.ops import fused, fused_vjp
from srack_tpu.presets import subtractive_voice, farm_params

CFG = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                     precision="fast")
FUSED_PRESETS = ["sine", "subtractive", "feedback", "sequencer"]


def _batch(compiled, params, v, seed=0):
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(seed), v)
    return state, keys


def _assert_states_close(got_tree, want_tree, atol=1e-5):
    for path, want in jax.tree_util.tree_leaves_with_path(want_tree):
        got = np.asarray(dict(jax.tree_util.tree_leaves_with_path(
            got_tree))[path])
        want = np.asarray(want)
        msg = jax.tree_util.keystr(path)
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=msg)
        else:
            np.testing.assert_allclose(got.astype(np.float64),
                                       want.astype(np.float64), atol=atol,
                                       err_msg=msg)


def test_fused_kernel_interpret_matches_scan():
    patch = subtractive_voice(CFG)
    compiled = st.compile_patch(patch)
    assert compiled.fused_eligible()
    v, n = 4, 32
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)

    run = fused.make_fused_render(compiled, n, unroll=4, interpret=True)
    audio_f, _, state_f = jax.jit(run)(params, state, keys, {})

    scan = compiled._get_fn(n, batched=True, engine="scan")
    audio_s, _, state_s = scan(params, state, keys, {})

    np.testing.assert_allclose(np.asarray(audio_f), np.asarray(audio_s),
                               atol=1e-5, rtol=0)
    # carried state agrees too (phase accumulators bit-exact in int32)
    _assert_states_close(state_f, state_s)


@pytest.mark.parametrize("name", ["sine", "feedback", "sequencer"])
def test_shell_preset_matches_scan(name):
    """Every fused-eligible preset runs in the shell: audio and final
    state match the scan engine.  The sequencer's [16] / [4] / [8, 16]
    table params reach its step as per-voice rows."""
    patch = presets.PRESETS[name](CFG)
    compiled = st.compile_patch(patch)
    assert compiled.fused_eligible()
    v, n = 3, 37
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)
    run = fused.make_fused_render(compiled, n, unroll=4, interpret=True)
    audio_f, _, state_f = jax.jit(run)(params, state, keys, {})
    audio_s, _, state_s = compiled.render(n, params=params, state=state,
                                          key=keys, batched=True,
                                          engine="scan")
    np.testing.assert_allclose(np.asarray(audio_f), np.asarray(audio_s),
                               atol=1e-5, rtol=0)
    _assert_states_close(state_f, state_s)


def test_fused_final_state_with_padded_tail():
    """n NOT a multiple of the unroll (or of the backward's chunk): the
    remainder samples after the unrolled loop must leave the carried state
    at exactly sample n, in the plain render and in the VJP forward."""
    patch = subtractive_voice(CFG)
    compiled = st.compile_patch(patch)
    v, n = 2, 23  # 23 = 5 * 4 + 3
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)
    scan = compiled._get_fn(n, batched=True, engine="scan")
    _, _, state_s = scan(params, state, keys, {})

    for make in (
        lambda: fused.make_fused_render(compiled, n, unroll=4,
                                        interpret=True),
        lambda: fused_vjp.make_fused_vjp(compiled, n, unroll=4,
                                         interpret=True),
    ):
        _, _, state_f = jax.jit(make())(params, state, keys, {})
        _assert_states_close(state_f["states"], state_s["states"])


def _grads_match(g1, g2, min_live):
    nonzero = 0
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        a64 = np.asarray(a, np.float64)
        b64 = np.asarray(b, np.float64)
        if b64.dtype.kind != "f":
            continue
        np.testing.assert_allclose(a64, b64,
                                   atol=1e-8 + 1e-4 * np.abs(b64).max())
        nonzero += np.abs(b64).max() > 0
    assert nonzero >= min_live  # gradients actually flowed


@pytest.mark.slow
def test_fused_vjp_padded_tail_final_state_cotangent():
    """d(loss)/d(params) through the final-state cotangent alone: it must
    be injected at sample n-1 of the backward's last (partial) chunk."""
    from srack_tpu.ops import shell

    patch = subtractive_voice(CFG, gate_rate_oct=-1.0)
    compiled = st.compile_patch(patch)
    v, n = 2, 23
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)
    render = fused_vjp.make_fused_vjp(compiled, n, unroll=4, interpret=True)
    scan_fn = compiled.make_render_fn(n, batched=True)
    assert n % shell.CHUNK

    def loss_of(fn):
        def loss(prm):
            _, _, fin = fn(prm, state, keys, {})
            # a loss purely on the *final state* exercises ct_final
            return sum((leaf.astype(jnp.float32) ** 2).mean()
                       for leaf in jax.tree.leaves(fin["states"])
                       if jnp.issubdtype(leaf.dtype, jnp.floating))
        return loss

    _grads_match(jax.grad(loss_of(render))(params),
                 jax.grad(loss_of(scan_fn))(params), 2)


def test_fused_vjp_interpret_matches_scan_grads():
    """Shell forward + shell backward (ops/fused_vjp) vs scan autodiff."""
    patch = subtractive_voice(CFG, gate_rate_oct=-1.0)
    compiled = st.compile_patch(patch)
    v, n = 2, 32
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)
    render = fused_vjp.make_fused_vjp(compiled, n, unroll=4, interpret=True)
    scan_fn = compiled.make_render_fn(n, batched=True)

    a1, _, _ = render(params, state, keys, {})
    a2, _, _ = scan_fn(params, state, keys, {})
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))

    def loss_of(fn):
        def loss(prm):
            audio, _, _ = fn(prm, state, keys, {})
            return (audio ** 2).mean()
        return loss

    _grads_match(jax.grad(loss_of(render))(params),
                 jax.grad(loss_of(scan_fn))(params), 4)


def test_shell_vjp_checkpoint_chunks_match_scan_grads():
    """The backward walks several checkpoint chunks in reverse, the first
    of them partial (n = 2 * 8 + 5): each chunk's states are recomputed
    from its checkpoint before the reverse sweep."""
    from srack_tpu.ops import shell

    patch = subtractive_voice(CFG, gate_rate_oct=-1.0)
    compiled = st.compile_patch(patch)
    v, n = 2, 21
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)
    out_keys = fused.channel_keys(compiled)

    def step(p, s, x_t):
        new_states, fb_out, channels, _ = compiled._sample_step(
            p, s["states"], s["fb"], x_t)
        return ({"states": new_states, "fb": fb_out},
                dict(zip(out_keys, channels)))

    core = shell.differentiable(step, n, out_keys, unroll=3, chunk=8,
                                interpret=True)
    w = jax.random.normal(jax.random.PRNGKey(3), (v, n))

    def loss_shell(prm):
        xs = fused.hoisted_lanes(compiled, prm, keys, {}, n)
        outs, _ = core(compiled.derived_params(prm), state, xs)
        return jnp.sum(outs["out0"] * w)

    scan_fn = compiled.make_render_fn(n, batched=True)

    def loss_scan(prm):
        return jnp.sum(scan_fn(prm, state, keys, {})[0][:, 0] * w)

    _grads_match(jax.grad(loss_shell)(params), jax.grad(loss_scan)(params),
                 4)


def test_shell_buffer_feedback_matches_scan():
    """Buffer-feedback compat mode in the shell: one kernel call per block
    under an outer scan, fb wires streamed in and out like lanes."""
    cfg = st.AudioConfig(sample_rate=4800, block_size=16, channels=1,
                         precision="fast", buffer_feedback=True)
    patch = presets.feedback_patch(cfg)
    compiled = st.compile_patch(patch)
    n, v = 48, 2
    params = st.replicate_params(compiled.default_params, v)
    state, keys = _batch(compiled, params, v)
    a_s, _, st_s = compiled.render(n, params=params, state=state, key=keys,
                                   batched=True, engine="scan")
    fn = jax.jit(fused.make_fused_render_buffer(compiled, n, interpret=True))
    a_f, _, st_f = fn(params, state, keys, {})
    np.testing.assert_allclose(np.asarray(a_f), np.asarray(a_s),
                               atol=3e-6, rtol=0)
    _assert_states_close(st_f, st_s, atol=3e-6)


@pytest.mark.slow
def test_fused_buffer_feedback_matches_scan_and_oracle():
    """Buffer-feedback compat mode on the shell (per-block kernel
    invocations under an outer scan, fb wires streamed like xs lanes)
    matches the scan engine and the oracle, including continued renders."""
    from srack_tpu.oracle import oracle_render
    cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                         precision="fast", buffer_feedback=True)
    patch = presets.feedback_patch(cfg)
    compiled = st.compile_patch(patch)
    n, v = 192, 2
    params = st.replicate_params(compiled.default_params, v)
    state, keys = _batch(compiled, params, v)
    a_s, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                batched=True, engine="scan")
    fn = jax.jit(fused.make_fused_render_buffer(compiled, n, interpret=True))
    a_f, _, st_f = fn(params, state, keys, {})
    np.testing.assert_allclose(np.asarray(a_f), np.asarray(a_s),
                               atol=3e-6, rtol=0)
    # continue from the shell's final state on the scan engine
    a_s2, _, _ = compiled.render(n, params=params, state=st_f, key=keys,
                                 batched=True, engine="scan")
    a_f2, _, _ = fn(params, st_f, keys, {})
    np.testing.assert_allclose(np.asarray(a_f2), np.asarray(a_s2),
                               atol=3e-6, rtol=0)
    want = oracle_render(patch, n)
    np.testing.assert_allclose(np.asarray(a_f[0]), want, atol=3e-4, rtol=0)


@pytest.mark.parametrize("name,channels", [("drums", 1), ("reverb", 2),
                                           ("subtractive", 1)])
def test_block_serial_stage_in_shell_matches_scan(name, channels):
    """The block engine's serial stage (Moog, ADSR and absorbed register
    modules) in the shell, Sample/Freeverb/scans in XLA: matches the scan
    engine as the lax.scan stage does."""
    cfg = st.AudioConfig(sample_rate=4800, block_size=64,
                         channels=channels, precision="fast")
    patch = presets.PRESETS[name](cfg)
    compiled = st.compile_patch(patch)
    prog = compiled.block_program()
    assert prog._use_shell(True)
    v, n = 2, 64
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)
    a_b, _, s_b = jax.jit(prog.make_run(n, interpret=True))(
        params, state, keys, {})
    a_s, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                batched=True, engine="scan")
    np.testing.assert_allclose(np.asarray(a_b), np.asarray(a_s),
                               atol=5e-6, rtol=0)


# -- the same programs lowered for CUDA (no GPU needed) ----------------------

def _lower_cuda(fn, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize("name", FUSED_PRESETS)
def test_fused_render_lowers_for_cuda(name):
    patch = presets.PRESETS[name](CFG)
    compiled = st.compile_patch(patch)
    v, n = 64, 256
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)
    text = _lower_cuda(fused.make_fused_render(compiled, n), params, state,
                       keys, {}).as_text()
    assert "voice_shell_fwd" in text


def test_block_serial_stage_lowers_for_cuda(monkeypatch):
    from srack_tpu import route

    patch = presets.drum_machine(CFG)
    compiled = st.compile_patch(patch)
    prog = compiled.block_program()
    v, n = 64, 256
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)
    # make_run(interpret=False) takes the shell only where the platform
    # has it: build the stage as on a GPU
    monkeypatch.setattr(route, "voice_kernel", lambda: True)
    text = _lower_cuda(prog.make_run(n), params, state, keys, {}).as_text()
    assert "voice_shell_fwd" in text


def test_vjp_backward_lowers_for_cuda():
    patch = subtractive_voice(CFG)
    compiled = st.compile_patch(patch)
    v, n = 64, 300  # two full checkpoint chunks and a partial one
    params = farm_params(patch, v)
    state, keys = _batch(compiled, params, v)
    render = fused_vjp.make_fused_vjp(compiled, n)

    def loss(prm):
        return jnp.mean(render(prm, state, keys, {})[0] ** 2)

    text = _lower_cuda(jax.grad(loss), params).as_text()
    assert "voice_shell_fwd" in text and "voice_shell_bwd" in text
