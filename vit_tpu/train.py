"""Training step (capability extension; the reference is inference-only).

The reference's roadmap explicitly scopes training out (reference
README.md:31-33) — this module exists so the framework can also fine-tune the
classifier variants end-to-end on a device mesh, and to exercise the full
DP+TP sharded compile path. It is deliberately thin: loss + optax update,
jitted once; gradients come from XLA autodiff of the forward; sharding
comes entirely from the inputs' ``NamedSharding``s (GSPMD propagation), so
the same step function runs on one device or on any ('data', 'model') mesh.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax

from vit_tpu.config import ViTConfig
from vit_tpu.models.vit import Params, forward


def cross_entropy_loss(params: Params, pixels: jax.Array, labels: jax.Array,
                       cfg: ViTConfig) -> jax.Array:
    """Mean softmax cross-entropy over a batch of integer labels."""
    assert cfg.num_classes > 0, "training requires a classification head"
    logits = forward(params, pixels, cfg)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    return jnp.mean(nll)


def make_optimizer(learning_rate: float = 1e-4,
                   weight_decay: float = 0.05) -> optax.GradientTransformation:
    return optax.adamw(learning_rate, weight_decay=weight_decay)


def make_train_step(cfg: ViTConfig,
                    optimizer: optax.GradientTransformation | None = None):
    """Returns ``(init_fn, step_fn)``, both jitted.

    ``init_fn(params) -> opt_state`` (inherits params' shardings);
    ``step_fn(params, opt_state, pixels, labels) -> (params, opt_state, loss)``.

    Distribution: sharding comes entirely from the inputs'
    ``NamedSharding``s (GSPMD, DP x Megatron-TP; vit_tpu/parallel/mesh.py).
    """
    optimizer = optimizer or make_optimizer()
    grad_fn = jax.value_and_grad(
        functools.partial(cross_entropy_loss, cfg=cfg))

    @jax.jit
    def init_fn(params: Params):
        return optimizer.init(params)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step_fn(params: Params, opt_state: Any, pixels: jax.Array,
                labels: jax.Array):
        loss, grads = grad_fn(params, pixels, labels)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return init_fn, step_fn
