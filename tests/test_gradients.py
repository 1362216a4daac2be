"""Gradient correctness pins.

The engine-agreement test (test_utils.test_grad_render_fn_matches_scan_grads)
compares the custom-VJP path against scan autodiff with a deliberately loose
relative bound, because the resonant filter's backward recurrence amplifies
f32 rounding.  That bound alone cannot tell "legitimately amplified float
noise" from "wrong gradient math" -- these tests pin the *absolute* scale:

* central finite differences in f64 arithmetic on the f32 render (the
  render itself is f32; with eps = 1e-3 the FD truncation error is O(eps^2)
  ~ 1e-6 and the f32 evaluation noise contributes ~ noise/eps ~ 1e-4, so a
  1% relative / 1e-3 absolute agreement bound is meaningful, not cosmetic);
* checked against BOTH scan autodiff and ``grad_render_fn``'s custom-VJP
  path (on a GPU the shell's kernels; on the CPU the scan engine behind
  the same custom VJP), per parameter, on a patch exercising the
  oscillator's pitch path, the Moog ladder, and the full ADSR trajectory.
"""

import numpy as np
import jax
import jax.numpy as jnp

import srack_tpu as st


def _patch(precision="fast"):
    cfg = st.AudioConfig(sample_rate=4800, block_size=64, channels=1,
                         precision=precision)
    p = st.Patch(cfg)
    clk = p.add("Oscillator", val=-5.0, name="clock")
    osc = p.add("Oscillator", val=-1.0, name="vco")
    # stage times deliberately off the sample lattice (sr*t not an integer):
    # at a lattice point the discrete stage length jumps for ANY fd step,
    # so no eps can stay inside one smooth piece
    env = p.add("ADSR", a_sec=0.004, d_sec=0.0093, s_val=0.4, r_sec=0.0117,
                name="env")
    flt = p.add("Moog Filter", freq=0.5, res=0.3, name="vcf")
    vca = p.add("VCA", name="vca")
    p.connect(clk, "Square", env, "Gate")
    p.connect(osc, "Sawtooth", flt, "Audio")
    p.connect(flt, 0, vca, "Audio")
    p.connect(env, 0, vca, "CV")
    p.connect(vca, 0, p.output, 0)
    return p


N = 256
# scalar params whose gradients we pin (module name, param leaf).  The
# oscillator's pitch (vco.val) is pinned separately: in exact mode through
# the f64 phase, in fast mode through the straight-through shadow phase
# (modules/oscillator.py pos_g -- the int32 fixed-point phase itself is
# non-differentiable; the STE carries d(phase)/d(delta) with a primal that
# cancels exactly).
# (module, param, fd_eps): envelope *time* params get a small eps because
# the stage lengths are discrete sample counts -- the loss is piecewise
# smooth in them, and the FD step must stay inside one smooth piece to
# measure the same (almost-everywhere) derivative autodiff computes.
PINNED = [("vcf", "freq", 1e-3), ("vcf", "res", 1e-3),
          ("env", "a_sec", 1e-5), ("env", "d_sec", 1e-5),
          ("env", "s_val", 1e-3), ("env", "r_sec", 1e-5)]


def _setup(precision="fast"):
    p = _patch(precision)
    compiled = st.compile_patch(p)
    params = compiled.default_params
    ids = {inst.name: inst.id for inst in p}
    key = jax.random.PRNGKey(0)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1, N)))

    scan_fn = compiled.make_render_fn(N, batched=False)

    def loss_scan(params):
        audio, _, _ = scan_fn(params, compiled.init_state(), key, {})
        return jnp.sum(audio * w)

    return compiled, params, ids, key, w, loss_scan


def _fd(loss_jit, params, mid, name, eps):
    def at(v):
        p2 = {m: dict(d) for m, d in params.items()}
        p2[mid][name] = jnp.asarray(v, dtype=params[mid][name].dtype)
        return float(loss_jit(p2))
    v0 = float(params[mid][name])
    return (at(v0 + eps) - at(v0 - eps)) / (2.0 * eps)


def test_scan_autodiff_matches_finite_differences():
    compiled, params, ids, key, w, loss_scan = _setup()
    loss_jit = jax.jit(loss_scan)
    grads = jax.jit(jax.grad(loss_scan))(params)
    for mod, name, eps in PINNED:
        mid = ids[mod]
        g_fd = _fd(loss_jit, params, mid, name, eps=eps)
        g_ad = float(grads[mid][name])
        tol = 2e-2 * max(abs(g_fd), abs(g_ad)) + 1e-2
        assert abs(g_ad - g_fd) <= tol, (
            f"{mod}.{name}: autodiff {g_ad:.6g} vs FD {g_fd:.6g}")


def test_fused_vjp_matches_finite_differences():
    """``grad_render_fn`` (on a GPU the shell's forward+backward kernels,
    ops/fused_vjp.py) reproduces finite-difference gradients -- the absolute
    pin that the loosened engine-agreement tolerance can't provide."""
    compiled, params, ids, key, w, loss_scan = _setup()
    loss_jit = jax.jit(loss_scan)

    gr = compiled.grad_render_fn(N, batched=True)

    def loss_fused(params):
        pb = jax.tree.map(lambda a: a[None], params)
        state = jax.tree.map(lambda a: a[None], compiled.init_state())
        audio, _, _ = gr(pb, state, key[None], {})
        return jnp.sum(audio[0] * w)

    grads = jax.jit(jax.grad(loss_fused))(params)
    for mod, name, eps in PINNED:
        mid = ids[mod]
        g_fd = _fd(loss_jit, params, mid, name, eps=eps)
        g_ad = float(grads[mid][name])
        tol = 2e-2 * max(abs(g_fd), abs(g_ad)) + 1e-2
        assert abs(g_ad - g_fd) <= tol, (
            f"{mod}.{name}: fused-vjp {g_ad:.6g} vs FD {g_fd:.6g}")


def test_pitch_gradient_exact_mode_matches_finite_differences():
    """Pitch gradients flow through the f64 phase accumulator in exact
    mode (fast mode's int32 fixed-point phase deliberately stops them)."""
    compiled, params, ids, key, w, loss_scan = _setup(precision="exact")
    loss_jit = jax.jit(loss_scan)
    grads = jax.jit(jax.grad(loss_scan))(params)
    mid = ids["vco"]
    g_fd = _fd(loss_jit, params, mid, "val", eps=1e-4)
    g_ad = float(grads[mid]["val"])
    assert abs(g_ad - g_fd) <= 3e-2 * max(abs(g_fd), abs(g_ad)) + 1e-3, (
        f"vco.val: autodiff {g_ad:.6g} vs FD {g_fd:.6g}")
    assert abs(g_fd) > 1.0  # the pitch path is live, not a stopped gradient


def test_pitch_gradient_fast_mode_ste_matches_finite_differences():
    """Fast-mode pitch gradients flow through the straight-through shadow
    phase (modules/oscillator.py pos_g).  The int32 phase stays exact; FD on
    the quantized render still resolves the derivative (a 1e-4-octave step
    moves the per-sample increment by ~1e4 fixed-point ulps)."""
    compiled, params, ids, key, w, loss_scan = _setup(precision="fast")
    loss_jit = jax.jit(loss_scan)
    grads = jax.jit(jax.grad(loss_scan))(params)
    mid = ids["vco"]
    g_fd = _fd(loss_jit, params, mid, "val", eps=1e-4)
    g_ad = float(grads[mid]["val"])
    assert abs(g_ad - g_fd) <= 5e-2 * max(abs(g_fd), abs(g_ad)) + 1e-3, (
        f"vco.val (fast/STE): autodiff {g_ad:.6g} vs FD {g_fd:.6g}")
    assert abs(g_fd) > 1.0

    # and through grad_render_fn's custom-VJP path
    gr = compiled.grad_render_fn(N, batched=True)

    def loss_fused(params):
        pb = jax.tree.map(lambda a: a[None], params)
        state = jax.tree.map(lambda a: a[None], compiled.init_state())
        audio, _, _ = gr(pb, state, key[None], {})
        return jnp.sum(audio[0] * w)

    g_k = float(jax.jit(jax.grad(loss_fused))(params)[mid]["val"])
    assert abs(g_k - g_fd) <= 5e-2 * max(abs(g_fd), abs(g_k)) + 1e-3, (
        f"vco.val (fused-vjp/STE): {g_k:.6g} vs FD {g_fd:.6g}")
