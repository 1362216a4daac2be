"""Differentiable sound-matching trainer.

Fits a patch's parameters to target audio by gradient descent through the
fully-fused render program -- the "training step" of this framework.  Scales
over a device mesh with data parallelism on the voice/target batch axis;
gradients of shared parameters reduce over the mesh (XLA inserts the psum).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import optax

from ..compiler import CompiledPatch, compile_patch
from ..patch import Patch
from .losses import multiscale_spectral_loss, waveform_l2


@dataclasses.dataclass
class SoundMatcher:
    """Optimises (a subset of) patch params against target audio.

    ``trainable``: predicate (module_id, param_name) -> bool choosing which
    leaves receive gradients (default: every float param).
    """

    patch: Patch
    n_samples: int
    loss_fn: Callable = multiscale_spectral_loss
    optimizer: optax.GradientTransformation = None
    trainable: Optional[Callable[[str, str], bool]] = None

    def __post_init__(self):
        self.compiled: CompiledPatch = compile_patch(self.patch)
        if self.optimizer is None:
            self.optimizer = optax.adam(1e-2)
        self._train_step = jax.jit(self._step_impl)

    def _split(self, params):
        # every module id appears in both trees (possibly empty) so the
        # merged params pytree always has the full structure
        train = {mid: {} for mid in params}
        frozen = {mid: {} for mid in params}
        for mid, pd in params.items():
            for name, leaf in pd.items():
                is_float = jnp.issubdtype(leaf.dtype, jnp.floating)
                ok = is_float if self.trainable is None else (
                    is_float and self.trainable(mid, name))
                (train if ok else frozen).setdefault(mid, {})[name] = leaf
        return train, frozen

    @staticmethod
    def _merge(train, frozen):
        out = {mid: {} for mid in frozen}
        for src in (frozen, train):
            for mid, pd in src.items():
                out.setdefault(mid, {}).update(pd)
        return out

    def init(self, params: Optional[dict] = None):
        if params is None:
            params = self.compiled.default_params
        train, frozen = self._split(params)
        return {"train": train, "frozen": frozen,
                "opt": self.optimizer.init(train)}

    def _render(self, params, key, drivers):
        # the scan engine is the autodiff path (pure jnp; the shell's
        # kernels need the custom-vjp wrapper in compiler.grad_render_fn)
        audio, _, _ = self.compiled.render(
            self.n_samples, params=params, key=key, drivers=drivers,
            engine="scan")
        return audio

    def _step_impl(self, ts, target, key, drivers):
        def loss_of(train):
            params = self._merge(train, ts["frozen"])
            audio = self._render(params, key, drivers)
            return self.loss_fn(audio, target)

        loss, grads = jax.value_and_grad(loss_of)(ts["train"])
        updates, opt_state = self.optimizer.update(grads, ts["opt"],
                                                  ts["train"])
        train = optax.apply_updates(ts["train"], updates)
        return {"train": train, "frozen": ts["frozen"], "opt": opt_state}, loss

    def step(self, train_state, target, key=None, drivers=None):
        """One optimisation step.  Returns (new_state, loss)."""
        if key is None:
            key = jax.random.PRNGKey(0)
        elif isinstance(key, int):
            key = jax.random.PRNGKey(key)
        return self._train_step(train_state, target, key, drivers or {})

    def params(self, train_state) -> dict:
        return self._merge(train_state["train"], train_state["frozen"])


def batched_train_step(compiled: CompiledPatch, optimizer, n_samples: int,
                       loss_fn: Callable = waveform_l2, fast: bool = False,
                       mesh=None):
    """A jittable *batched* training step.

    Shared (replicated) trainable params, a batch of targets + noise keys:
    ``fn(train_params, frozen_params, opt_state, targets[V,C,n], keys[V,2])
    -> (train_params, opt_state, loss)``.  The per-voice losses
    mean-reduce, so on a mesh the gradient all-reduce is inserted by XLA --
    no hand-written collectives.

    ``fast=True`` renders through ``compiler.grad_render_fn``: on a GPU the
    voice-kernel shell's forward and backward kernels, elsewhere the scan
    engine behind a custom VJP.  ``pallas_call`` itself is not
    SPMD-partitionable, so passing ``mesh`` wraps the render in
    ``jax.shard_map`` over the batch axis: each device renders its batch
    shard, and shard_map's transpose inserts the gradient psum for the
    replicated params.
    """
    if fast:
        gr = compiled.grad_render_fn(n_samples, batched=True)

        def _render_shard(params, keys):
            v = keys.shape[0]
            params_b = jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (v,) + a.shape), params)
            state = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (v,) + a.shape),
                compiled.init_state())
            audio, _, _ = gr(params_b, state, keys, {})
            return audio

        if mesh is None:
            render_batchd = _render_shard
        else:
            from jax.sharding import PartitionSpec as P
            bspec = P(mesh.axis_names)
            # check_vma=False: pallas_call's outputs carry no
            # varying-axes type
            render_batchd = jax.shard_map(
                _render_shard, mesh=mesh,
                in_specs=(P(), bspec), out_specs=bspec, check_vma=False)
    else:
        def render_one(params, key):
            state = compiled.init_state()
            audio, _, _ = compiled.make_render_fn(n_samples, batched=False)(
                params, state, key, {})
            return audio

        def render_batchd(params, keys):
            return jax.vmap(render_one, in_axes=(None, 0))(params, keys)

    def step(train, frozen, opt_state, targets, keys):
        def loss_of(train):
            params = SoundMatcher._merge(train, frozen)
            audio = render_batchd(params, keys)
            return jax.vmap(loss_fn)(audio, targets).mean()

        loss, grads = jax.value_and_grad(loss_of)(train)
        updates, opt_state = optimizer.update(grads, opt_state, train)
        train = optax.apply_updates(train, updates)
        return train, opt_state, loss

    return step


def multi_train_step(compiled: CompiledPatch, optimizer, n_samples: int,
                     n_steps: int, loss_fn: Callable = waveform_l2,
                     fast: bool = False, mesh=None):
    """``n_steps`` optimisation steps in ONE jitted dispatch.

    A ``lax.scan`` over :func:`batched_train_step` against fixed targets:
    ``fn(train, frozen, opt_state, targets, keys) ->
    (train, opt_state, losses[n_steps])``.  This is how a real training
    loop runs: one dispatch, no host round trip between steps.  Noise keys
    fold per step so each step sees fresh noise lanes, like an un-scanned
    loop would.
    """
    one = batched_train_step(compiled, optimizer, n_samples,
                             loss_fn=loss_fn, fast=fast, mesh=mesh)

    def run(train, frozen, opt_state, targets, keys):
        def body(carry, i):
            tr, opt = carry
            ks = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
            tr, opt, loss = one(tr, frozen, opt, targets, ks)
            return (tr, opt), loss

        (train, opt_state), losses = jax.lax.scan(
            body, (train, opt_state), jnp.arange(n_steps))
        return train, opt_state, losses

    return run
