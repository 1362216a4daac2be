"""User-defined module types via srack_tpu.register_module.

The reference is extended by implementing the ``SynthModule`` trait and
adding the type to ``get_catalog()`` (src/synth.rs:216-263, 421-515); the
JAX analogue is building a :class:`ModuleDef` out of pure functions and
registering it.  These tests pin the whole contract end to end: catalog
validation, every engine (scan, block serial stage, voice-kernel shell
via ``register_safe=True``), JSON persistence, and a NumPy oracle for the
semantics of the example module itself.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import srack_tpu as st
from srack_tpu.modules import CATALOG, ModuleDef
from srack_tpu.modules.base import CV_DTYPE, const_ports, cv, in_or

CFG_KW = dict(sample_rate=4800, block_size=64, channels=1)


# -- the example custom module: a slew limiter -------------------------------
# A classic modular utility the reference catalog does not even have: the
# output chases the input with a bounded per-sample step (rate in CV units
# per second).  Stateful (one f32 per voice), elementwise math only.

def _slew_make(cfg, rate: float = 10.0):
    return ("slew",), {"rate": cv(rate)}


def _slew_init_state(cfg, statics):
    return {"y": jnp.zeros((), dtype=CV_DTYPE)}


def _slew_derive(cfg, statics, params, connected):
    # per-sample step size is loop-invariant: hoist the divide
    return {"step": params["rate"] / cfg.sample_rate}


def _slew_step(cfg, statics, params, state, ins, x=None):
    target = in_or(ins[0], 0.0)
    step = params.get("step", params["rate"] / cfg.sample_rate)
    y = state["y"] + jnp.clip(target - state["y"], -step, step)
    return {"y": y}, (y.astype(CV_DTYPE),)


def _slew_def(**kw) -> ModuleDef:
    nin, inlabels = const_ports(1, ("In",))
    nout, outlabels = const_ports(1, (None,))
    return ModuleDef(
        type_name="Slew Limiter",
        make=_slew_make,
        num_inputs=nin,
        num_outputs=nout,
        input_labels=inlabels,
        output_labels=outlabels,
        init_state=_slew_init_state,
        step=_slew_step,
        derive=_slew_derive,
        **kw,
    )


@pytest.fixture
def slew():
    mdef = st.register_module(_slew_def(register_safe=True))
    yield mdef
    st.unregister_module(mdef.type_name)


def slew_oracle(x, rate, sr):
    """Independent NumPy restatement of the slew semantics."""
    y = np.zeros(len(x), dtype=np.float64)
    acc = 0.0
    step = rate / sr
    for i, t in enumerate(np.asarray(x, dtype=np.float64)):
        acc += np.clip(t - acc, -step, step)
        y[i] = acc
    return y


def _slew_patch(cfg, rate=40.0):
    p = st.Patch(cfg)
    drv = p.add("Input")
    sl = p.add("Slew Limiter", rate=rate)
    p.connect(drv, 0, sl, "In")
    p.connect(sl, 0, p.output, 0)
    return p, drv


# -- catalog validation ------------------------------------------------------

def test_register_validation(slew):
    assert "Slew Limiter" in CATALOG
    with pytest.raises(ValueError, match="already registered"):
        st.register_module(_slew_def())
    st.register_module(_slew_def(), replace=True)  # custom replace is fine
    with pytest.raises(ValueError, match="built-in"):
        st.register_module(
            ModuleDef(type_name="VCA", make=_slew_make,
                      num_inputs=const_ports(1, ("In",))[0],
                      num_outputs=const_ports(1, (None,))[1],
                      input_labels=const_ports(1, ("In",))[1],
                      output_labels=const_ports(1, (None,))[1],
                      init_state=_slew_init_state, step=_slew_step),
            replace=True)
    with pytest.raises(ValueError, match="built-in"):
        st.unregister_module("Oscillator")
    with pytest.raises(TypeError):
        st.register_module(object())
    with pytest.raises(KeyError):
        st.unregister_module("No Such Module")


def test_unknown_type_error_names_catalog():
    cfg = st.AudioConfig(**CFG_KW)
    with pytest.raises(KeyError, match="unknown module type"):
        st.Patch(cfg).add("Slew Limiter")  # not registered here


# -- engines -----------------------------------------------------------------

def test_scan_matches_numpy_oracle(slew):
    cfg = st.AudioConfig(precision="exact", **CFG_KW)
    p, drv = _slew_patch(cfg, rate=40.0)
    n = 400
    x = np.sign(np.sin(np.arange(n) * 0.05)).astype(np.float32)  # squarish
    audio, _, _ = st.render(p, n, drivers={drv: x}, engine="scan")
    want = slew_oracle(x, 40.0, cfg.sample_rate)
    # f32 state accumulator vs the f64 oracle: ~1 ulp/sample of drift
    np.testing.assert_allclose(np.asarray(audio)[0], want, atol=3e-5)


def test_block_engine_serial_stage_matches_scan(slew):
    """Stateful custom module without a block impl joins the serial stage
    automatically; block output must match scan exactly."""
    cfg = st.AudioConfig(precision="exact", **CFG_KW)
    p, drv = _slew_patch(cfg)
    compiled = st.compile_patch(p)
    prog = compiled.block_program()
    sl_mid = [mid for mid, (mdef, _, _) in compiled.instances.items()
              if mdef.type_name == "Slew Limiter"]
    assert sl_mid[0] in prog.stage_set
    n = 300
    x = np.random.default_rng(0).uniform(-1, 1, n).astype(np.float32)
    a_s, _, _ = st.render(p, n, drivers={drv: x}, engine="scan")
    a_b, _, _ = st.render(p, n, drivers={drv: x}, engine="block")
    np.testing.assert_allclose(np.asarray(a_b), np.asarray(a_s), atol=5e-6)


def test_fused_kernel_accepts_register_safe(slew):
    """register_safe=True admits the custom type to the voice-kernel
    shell (interpret mode on the CPU); output matches the scan engine."""
    from srack_tpu.ops import fused
    from srack_tpu.presets import farm_params

    cfg = st.AudioConfig(precision="fast", **CFG_KW)
    p = st.Patch(cfg)
    osc = p.add("Oscillator", val=-1.0)
    sl = p.add("Slew Limiter", rate=2000.0)
    p.connect(osc, "Square", sl, "In")
    p.connect(sl, 0, p.output, 0)
    compiled = st.compile_patch(p)
    assert compiled.fused_eligible()

    v, n = 4, 32
    params = farm_params(p, v)
    state = jax.tree.map(lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                         compiled.init_state())
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    run = fused.make_fused_render(compiled, n, unroll=4,
                                  interpret=True)
    audio_f, _, _ = jax.jit(run)(params, state, keys, {})
    audio_s, _, _ = compiled.render(n, params=params, state=state, key=keys,
                                    batched=True, engine="scan")
    np.testing.assert_allclose(np.asarray(audio_f), np.asarray(audio_s),
                               atol=1e-5, rtol=0)


def test_without_register_safe_not_fused(slew):
    mdef = _slew_def()  # register_safe defaults to False
    st.register_module(mdef, replace=True)
    cfg = st.AudioConfig(precision="fast", **CFG_KW)
    p, _ = _slew_patch(cfg)
    assert not st.compile_patch(p).fused_eligible()


# -- persistence -------------------------------------------------------------

def test_patchfile_roundtrip(slew):
    cfg = st.AudioConfig(precision="exact", **CFG_KW)
    p, drv = _slew_patch(cfg, rate=17.5)
    text = st.io.patchfile.save_patch(p)
    q = st.io.patchfile.load_patch(text)
    n = 200
    x = np.random.default_rng(1).uniform(-1, 1, n).astype(np.float32)
    a_p, _, _ = st.render(p, n, drivers={drv: x}, engine="scan")
    drv_q = [h for h in (q.handle(i.id) for i in q)
             if h.type_name == "Input"][0]
    a_q, _, _ = st.render(q, n, drivers={drv_q: x}, engine="scan")
    np.testing.assert_array_equal(np.asarray(a_p), np.asarray(a_q))


def test_patchfile_unknown_type_message(slew):
    cfg = st.AudioConfig(precision="exact", **CFG_KW)
    p, _ = _slew_patch(cfg)
    text = st.io.patchfile.save_patch(p)
    st.unregister_module("Slew Limiter")
    try:
        with pytest.raises(ValueError, match="register_module"):
            st.io.patchfile.load_patch(text)
    finally:
        st.register_module(_slew_def(register_safe=True))


# -- re-registration & the compile cache -------------------------------------

def test_reregister_compiles_fresh():
    """register(replace=True) must not hit a compile-cache entry built from
    the old implementation (topology_key carries the ModuleDef identity)."""
    def gain_def(scale):
        def _step(cfg, statics, params, state, ins, x=None):
            return state, ((in_or(ins[0], 0.0) * scale).astype(CV_DTYPE),)
        nin, inlabels = const_ports(1, ("In",))
        nout, outlabels = const_ports(1, (None,))
        return ModuleDef(
            type_name="Gain Probe", make=lambda cfg: (("gp",), {}),
            num_inputs=nin, num_outputs=nout, input_labels=inlabels,
            output_labels=outlabels, init_state=lambda cfg, s: {},
            step=_step)

    def build():
        cfg = st.AudioConfig(precision="exact", **CFG_KW)
        p = st.Patch(cfg)
        drv = p.add("Input")
        g = p.add("Gain Probe")
        p.connect(drv, 0, g, "In")
        p.connect(g, 0, p.output, 0)
        return p, drv

    st.register_module(gain_def(1.0))
    try:
        n = 64
        x = np.ones(n, np.float32)
        p1, d1 = build()
        a1, _, _ = st.render(p1, n, drivers={d1: x}, engine="scan")
        np.testing.assert_allclose(np.asarray(a1)[0], x, atol=0)

        st.register_module(gain_def(2.0), replace=True)
        p2, d2 = build()
        a2, _, _ = st.render(p2, n, drivers={d2: x}, engine="scan")
        np.testing.assert_allclose(np.asarray(a2)[0], 2.0 * x, atol=0)
    finally:
        st.unregister_module("Gain Probe")


# -- make_xs lanes through the block engine's serial stage --------------------

def _leaky_def():
    """Stateful custom module with a make_xs lane and no block impl: the
    block engine forces it into the serial stage, which must stream the
    hoisted lane per sample exactly as the scan engine's x_t.get(mid)."""
    def _make(cfg, gain: float = 1.0):
        return ("leaky",), {"gain": cv(gain)}

    def _init_state(cfg, statics):
        return {"acc": jnp.zeros((), dtype=CV_DTYPE)}

    def _make_xs(cfg, statics, params, key, n):
        return jax.random.uniform(key, (n,), dtype=CV_DTYPE) - 0.5

    def _step(cfg, statics, params, state, ins, x=None):
        acc = 0.9 * state["acc"] + params["gain"] * x
        return {"acc": acc}, (acc.astype(CV_DTYPE),)

    nin, inlabels = const_ports(0, ())
    nout, outlabels = const_ports(1, (None,))
    return ModuleDef(
        type_name="Leaky Noise", make=_make, num_inputs=nin,
        num_outputs=nout, input_labels=inlabels, output_labels=outlabels,
        init_state=_init_state, step=_step, make_xs=_make_xs)


def test_serial_stage_streams_make_xs_lanes():
    st.register_module(_leaky_def())
    try:
        cfg = st.AudioConfig(precision="exact", **CFG_KW)
        p = st.Patch(cfg)
        lk = p.add("Leaky Noise")
        p.connect(lk, 0, p.output, 0)
        compiled = st.compile_patch(p)
        prog = compiled.block_program()
        assert lk.id in prog.stage_set  # stateful, no block impl
        n = 256
        a_s, _, _ = st.render(p, n, key=7, engine="scan")
        a_b, _, _ = st.render(p, n, key=7, engine="block")
        assert float(np.abs(np.asarray(a_s)).max()) > 1e-3  # lane is live
        np.testing.assert_allclose(np.asarray(a_b), np.asarray(a_s),
                                   atol=1e-6, rtol=0)
    finally:
        st.unregister_module("Leaky Noise")
