"""Gradients of the ops and of the model, as XLA autodiff computes them.

``jax.test_util.check_grads`` compares reverse- and forward-mode
derivatives with central finite differences (step 1e-3, float32 — the ops
accumulate in float32 whatever the input dtype — at check_grads' float32
tolerance). Training (vit_tpu/train.py) takes its gradients from exactly
this autodiff of the plain ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

from vit_tpu import ops
from vit_tpu.config import ViTConfig
from vit_tpu.models import vit


def _r(rng, *shape, scale=0.5):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.float32)


def _check(f, args):
    check_grads(f, args, order=1, modes=("fwd", "rev"), eps=1e-3)


@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_matmul_grads(rng, activation, with_bias):
    x, w = _r(rng, 2, 6, 8), _r(rng, 8, 5)
    b = _r(rng, 5) if with_bias else None
    _check(lambda x, w: jnp.sum(jnp.sin(ops.matmul(x, w, b, activation))),
           (x, w))
    if with_bias:
        _check(lambda b: jnp.sum(jnp.sin(ops.matmul(x, w, b, activation))),
               (b,))


def test_layernorm_grads(rng):
    x = _r(rng, 2, 5, 8, scale=1.0)
    g, b = 1 + _r(rng, 8, scale=0.1), _r(rng, 8, scale=0.1)
    _check(lambda x, g, b: jnp.sum(jnp.sin(ops.layernorm(x, g, b,
                                                         eps=1e-6))),
           (x, g, b))


def test_softmax_grads(rng):
    _check(lambda x: jnp.sum(jnp.sin(ops.softmax(x))), (_r(rng, 3, 7),))


def test_gelu_grads(rng):
    _check(lambda x: jnp.sum(ops.gelu(x)), (_r(rng, 16, scale=2.0),))


@pytest.mark.parametrize("s", [8, 13])
def test_attention_grads(rng, s):
    q, k, v = (_r(rng, 1, s, 2, 4) for _ in range(3))  # (B, S, H, d)
    _check(lambda q, k, v: jnp.sum(jnp.sin(ops.attention(q, k, v))),
           (q, k, v))


def test_patch_embed_grads(rng):
    x = _r(rng, 1, 3, 8, 8)
    w, b = _r(rng, 3 * 4 * 4, 6, scale=0.1), _r(rng, 6, scale=0.1)
    _check(lambda x, w, b: jnp.sum(jnp.sin(ops.patch_embed(x, w, b, 4))),
           (x, w, b))


@pytest.mark.parametrize("leaf", ["pixels", "fc1", "qkv", "classifier"])
def test_model_loss_grads(rng, leaf):
    """The training loss through the whole forward (embed, scanned blocks,
    final LN, classifier) differentiates correctly with respect to the
    input and to weights at both ends of the network."""
    from vit_tpu.train import cross_entropy_loss

    cfg = ViTConfig(image_size=8, patch_size=4, hidden_dim=8, num_heads=2,
                    num_layers=2, mlp_dim=16, num_classes=3)
    params = vit.init_params(jax.random.key(0), cfg)
    px = _r(rng, 2, 3, 8, 8, scale=1.0)
    labels = jnp.asarray([0, 2])

    def with_leaf(x):
        if leaf == "pixels":
            return params, x
        p = jax.tree.map(lambda a: a, params)
        if leaf == "classifier":
            p["classifier"] = dict(p["classifier"], kernel=x)
        else:
            p["encoder"][leaf] = dict(p["encoder"][leaf], kernel=x)
        return p, px

    x0 = {"pixels": px, "classifier": params["classifier"]["kernel"]}.get(
        leaf, params["encoder"].get(leaf, {}).get("kernel"))
    _check(lambda x: cross_entropy_loss(*with_leaf(x), labels, cfg), (x0,))


def test_train_step_moves_against_the_gradient(rng):
    """One plain-SGD step lowers the loss on its own batch."""
    import optax

    from vit_tpu.train import cross_entropy_loss, make_train_step

    cfg = ViTConfig(image_size=16, patch_size=8, hidden_dim=16, num_heads=2,
                    num_layers=2, mlp_dim=32, num_classes=4,
                    dtype=jnp.float32)
    params = vit.init_params(jax.random.key(1), cfg)
    px = _r(rng, 4, 3, 16, 16, scale=1.0)
    labels = jnp.asarray([0, 1, 2, 3])
    before = float(cross_entropy_loss(params, px, labels, cfg))
    init_fn, step_fn = make_train_step(cfg, optax.sgd(0.05))
    params2, _, loss = step_fn(jax.tree.map(jnp.copy, params),
                               init_fn(params), px, labels)
    assert np.isclose(float(loss), before)
    assert float(cross_entropy_loss(params2, px, labels, cfg)) < before


@pytest.mark.parametrize("s", [8, 13])
def test_fused_route_takes_the_plain_gradient(rng, s):
    """The fused route's wrapper: its forward is the fused function, its
    gradient the plain chain's (here with a fused stand-in that is the
    plain chain times 2, so the two parts are told apart)."""
    from vit_tpu.ops import _plain_attention, _with_plain_backward

    q, k, v = (_r(rng, 1, s, 2, 4) for _ in range(3))
    fused = _with_plain_backward(lambda q, k, v, sc: 2 * _plain_attention(
        q, k, v, sc))
    np.testing.assert_allclose(np.asarray(fused(q, k, v, 0.5)),
                               2 * np.asarray(_plain_attention(q, k, v, 0.5)),
                               rtol=1e-6)
    loss = lambda f: (lambda q, k, v: jnp.sum(jnp.sin(f(q, k, v, 0.5))))
    g_fused = jax.grad(loss(fused), argnums=(0, 1, 2))(q, k, v)
    # d/dx sum(sin(2y)) != d/dx sum(sin(y)); the wrapper must use the
    # plain chain's VJP at the cotangent it is given.
    g_plain = jax.vjp(lambda q, k, v: _plain_attention(q, k, v, 0.5),
                      q, k, v)[1](jnp.cos(fused(q, k, v, 0.5)))
    for a, b in zip(g_fused, g_plain):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.gpu
def test_cudnn_route_gradients_match_plain_chain(gpu, rng):
    """On the card: bf16 cuDNN attention forward within bf16 of the plain
    chain, gradients through it exactly the plain chain's VJP (S=197)."""
    from vit_tpu.ops import _plain_attention

    q, k, v = (jnp.asarray(rng.standard_normal((2, 197, 12, 64)),
                           jnp.bfloat16) for _ in range(3))
    got = ops.attention(q, k, v)
    want = _plain_attention(q, k, v, 64 ** -0.5)
    assert float(jnp.max(jnp.abs(got.astype(jnp.float32)
                                 - want.astype(jnp.float32)))) < 2e-2
    g = jax.grad(lambda q: jnp.sum(ops.attention(q, k, v).astype(
        jnp.float32)))(q)
    assert np.isfinite(np.asarray(g, np.float32)).all()
