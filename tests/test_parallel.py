"""Mesh/sharding + training-step tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_tpu.config import ViTConfig
from vit_tpu.models import vit
from vit_tpu.parallel import batch_sharding, make_mesh, param_shardings
from vit_tpu.train import make_train_step

TINY = ViTConfig(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
                 num_layers=2, mlp_dim=128, num_classes=8)


def _setup(mesh, batch):
    params = vit.init_params(jax.random.key(0), TINY)
    params = jax.device_put(params, param_shardings(params, mesh, TINY))
    rng = np.random.default_rng(0)
    px = jax.device_put(
        jnp.asarray(rng.standard_normal((batch, 3, 32, 32)), jnp.float32),
        batch_sharding(mesh))
    labels = jax.device_put(jnp.asarray(rng.integers(0, 8, (batch,)), jnp.int32),
                            batch_sharding(mesh))
    return params, px, labels


def test_requires_8_devices():
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"


def test_dp_forward_matches_single_device():
    mesh = make_mesh(data=8, model=1)
    params, px, _ = _setup(mesh, batch=8)
    sharded = jax.jit(lambda p, x: vit.forward(p, x, TINY))(params, px)
    local = vit.forward(jax.device_get(params), jax.device_get(px), TINY)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(local), atol=1e-5)


def test_tp_forward_matches_single_device():
    mesh = make_mesh(data=2, model=4)
    params, px, _ = _setup(mesh, batch=4)
    sharded = jax.jit(lambda p, x: vit.forward(p, x, TINY))(params, px)
    local = vit.forward(jax.device_get(params), jax.device_get(px), TINY)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(local), atol=1e-5)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
def test_train_step_on_mesh(data, model):
    mesh = make_mesh(data=data, model=model)
    params, px, labels = _setup(mesh, batch=2 * data)
    init_fn, step_fn = make_train_step(TINY)
    opt_state = init_fn(params)
    params2, opt_state, loss = step_fn(params, opt_state, px, labels)
    assert np.isfinite(float(loss))
    # One more step to confirm donated buffers / state threading works.
    params2, opt_state, loss2 = step_fn(params2, opt_state, px, labels)
    assert np.isfinite(float(loss2)) and float(loss2) != float(loss)


@pytest.mark.parametrize("data,model", [(4, 1), (2, 2)])
def test_train_step_mesh_matches_single_device(data, model):
    """A DP x TP step under GSPMD takes the single-device step's loss and
    gradients (compared before AdamW, whose normalised update would hide
    a gradient difference), and its step runs on the mesh."""
    import functools

    from vit_tpu.train import cross_entropy_loss

    mesh = make_mesh(data=data, model=model)
    params, px, labels = _setup(mesh, batch=2 * data)
    vg = jax.jit(jax.value_and_grad(
        functools.partial(cross_entropy_loss, cfg=TINY)))
    loss_m, grads_m = vg(params, px, labels)
    loss_1, grads_1 = vg(jax.device_get(params), jax.device_get(px),
                         jax.device_get(labels))
    np.testing.assert_allclose(float(loss_m), float(loss_1), atol=1e-5)
    for a, b in zip(jax.tree.leaves(grads_m), jax.tree.leaves(grads_1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    init_fn, step_fn = make_train_step(TINY)
    _, _, loss = step_fn(params, init_fn(params), px, labels)
    np.testing.assert_allclose(float(loss), float(loss_1), atol=1e-5)


def test_graft_entry_single_chip():
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (8, 197, 768)


def test_graft_entry_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_train_state_checkpoint_on_mesh(tmp_path):
    # Save a SHARDED training state (params on DP2xTP4, opt state inheriting
    # the shardings), restore straight back onto the mesh, resume one step —
    # identical to the uninterrupted run.
    from vit_tpu.weights.checkpoint import (restore_train_state,
                                            save_train_state)

    mesh = make_mesh(data=2, model=4)
    params, px, labels = _setup(mesh, batch=4)
    init_fn, step_fn = make_train_step(TINY)
    opt_state = init_fn(params)

    keep = jax.tree.map(jnp.copy, (params, opt_state))  # step donates
    params, opt_state, _ = step_fn(params, opt_state, px, labels)
    save_train_state(str(tmp_path / "st"), params, opt_state, 1)
    ref_params, ref_opt, ref_loss = step_fn(params, opt_state, px, labels)

    # Fresh target structure with the same shardings.
    like_params = jax.device_put(vit.init_params(jax.random.key(1), TINY),
                                 param_shardings(keep[0], mesh, TINY))
    like = (like_params, init_fn(like_params))
    params2, opt2, step = restore_train_state(str(tmp_path / "st"), like)
    assert step == 1
    leaf = params2["encoder"]["qkv"]["kernel"]
    assert not leaf.sharding.is_fully_replicated  # restored already-placed
    params2, opt2, loss2 = step_fn(params2, opt2, px, labels)
    assert float(loss2) == float(ref_loss)
    for a, b in zip(jax.tree.leaves(ref_params), jax.tree.leaves(params2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_int8_tp_forward_matches_single_device():
    """Int8 TP (VERDICT r2 #7): the quant pytree Megatron-shards over
    'model' (int8 kernels split like float ones, scales follow the output
    dim) and the XLA quant forward matches the single-device result."""
    from vit_tpu.quant import forward_quant, quantize_params

    mesh = make_mesh(data=2, model=4)
    params = vit.init_params(jax.random.key(0), TINY)
    qparams = quantize_params(params)
    qsh = param_shardings(qparams, mesh, TINY)
    # Quantized kernels got the dict-shaped rule.
    assert set(qsh["encoder"]["qkv"]["kernel"]) == {"q", "scale"}
    qparams_sharded = jax.device_put(qparams, qsh)
    rng = np.random.default_rng(0)
    px = jax.device_put(
        jnp.asarray(rng.standard_normal((4, 3, 32, 32)), jnp.float32),
        batch_sharding(mesh))
    sharded = jax.jit(lambda p, x: forward_quant(p, x, TINY))(
        qparams_sharded, px)
    local = forward_quant(jax.device_get(qparams), jax.device_get(px), TINY)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(local),
                               atol=1e-4)


@pytest.mark.parametrize("data,model", [(1, 4), (4, 1), (2, 2)])
def test_mesh_forward_matches_single_device(data, model):
    """GSPMD forward on every small mesh shape (pure TP, pure DP, DP x TP)
    equals the single-device forward."""
    mesh = make_mesh(data=data, model=model)
    params, px, _ = _setup(mesh, batch=2 * data)
    sharded = jax.jit(lambda p, x: vit.forward(p, x, TINY))(params, px)
    local = vit.forward(jax.device_get(params), jax.device_get(px), TINY)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(local),
                               atol=1e-5)


def test_mesh_predictor_serves_on_mesh():
    from vit_tpu.serving import Predictor

    mesh = make_mesh(data=2, model=4)
    params = vit.init_params(jax.random.key(0), TINY)
    pred = Predictor(params, TINY, buckets=(2, 4), mesh=mesh)
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.standard_normal((5, 3, 32, 32)), jnp.float32)
    out = pred(px)
    assert out.shape == (5, TINY.num_classes)
    local = vit.forward(params, px, TINY)
    np.testing.assert_allclose(np.asarray(out), np.asarray(local), atol=1e-5)


def test_int8_tp_predictor_serves_on_mesh():
    from vit_tpu.serving import Predictor

    mesh = make_mesh(data=2, model=4)
    params = vit.init_params(jax.random.key(0), TINY)
    pred = Predictor(params, TINY, buckets=(2, 4), mesh=mesh, quant=True)
    rng = np.random.default_rng(0)
    out = pred(jnp.asarray(rng.standard_normal((5, 3, 32, 32)), jnp.float32))
    assert out.shape == (5, TINY.num_classes)
    assert np.all(np.isfinite(np.asarray(out)))


def test_int8_predictor_2x2_matches_single_device():
    """Int8 serving on a 2x2 DP x TP mesh: Megatron-split int8 kernels,
    scales following the output dim, same answers as one device."""
    from vit_tpu.quant import forward_quant, quantize_params
    from vit_tpu.serving import Predictor

    mesh = make_mesh(data=2, model=2)
    params = vit.init_params(jax.random.key(0), TINY)
    pred = Predictor(params, TINY, buckets=(2, 4), mesh=mesh, quant=True)
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.standard_normal((5, 3, 32, 32)), jnp.float32)
    out = pred(px)
    assert out.shape == (5, TINY.num_classes)
    local = forward_quant(quantize_params(params), px, TINY)
    np.testing.assert_allclose(np.asarray(out), np.asarray(local), atol=1e-4)
