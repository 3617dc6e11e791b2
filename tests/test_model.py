import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_tpu.config import ViTConfig
from vit_tpu.models import vit

# A small config so CPU tests are fast: 32px / P=16 -> 5 tokens.
SMALL = ViTConfig(image_size=32, patch_size=16, hidden_dim=48, num_heads=4,
                  num_layers=3, mlp_dim=96)


def _pixels(rng, cfg, b=2):
    return jnp.asarray(rng.standard_normal(
        (b, cfg.num_channels, cfg.image_size, cfg.image_size)).astype(np.float32))


def test_forward_shape(rng):
    params = vit.init_params(jax.random.key(0), SMALL)
    out = vit.forward(params, _pixels(rng, SMALL), SMALL)
    assert out.shape == (2, SMALL.seq_len, SMALL.hidden_dim)
    assert np.isfinite(np.asarray(out)).all()


def test_forward_jit_fixed_shape(rng):
    fwd = vit.make_forward(SMALL)
    params = vit.init_params(jax.random.key(0), SMALL)
    out = fwd(params, _pixels(rng, SMALL))
    assert out.shape == (2, SMALL.seq_len, SMALL.hidden_dim)


def test_flash_equals_unfused_attention(rng):
    # Whatever attention route the platform picks, the forward must match
    # the reference's exact op chain (matmul3 -> softmax -> matmul3,
    # reference vit/vit.py:66-72), here the float64 NumPy oracle's.
    import np_oracle

    params = vit.init_params(jax.random.key(1), SMALL)
    px = _pixels(rng, SMALL)
    a = vit.forward(params, px, SMALL)
    b = np_oracle.forward(params, px, SMALL)
    np.testing.assert_allclose(np.asarray(a, np.float64), b, atol=1e-5)


def test_pooling_and_classifier_modes(rng):
    px = _pixels(rng, SMALL)

    cls_cfg = SMALL.replace(pooling="cls")
    params = vit.init_params(jax.random.key(0), cls_cfg)
    out = vit.forward(params, px, cls_cfg)
    assert out.shape == (2, SMALL.hidden_dim)

    mean_cfg = SMALL.replace(pooling="mean")
    out = vit.forward(params, px, mean_cfg)
    assert out.shape == (2, SMALL.hidden_dim)

    head_cfg = SMALL.replace(num_classes=10)
    params = vit.init_params(jax.random.key(0), head_cfg)
    logits = vit.forward(params, px, head_cfg)
    assert logits.shape == (2, 10)


def test_intermediates_match_forward(rng):
    params = vit.init_params(jax.random.key(2), SMALL)
    px = _pixels(rng, SMALL)
    final, hiddens = vit.forward_with_intermediates(params, px, SMALL)
    assert len(hiddens) == SMALL.num_layers + 1
    np.testing.assert_allclose(np.asarray(final),
                               np.asarray(vit.forward(params, px, SMALL)),
                               atol=1e-6)


def test_input_shape_validation(rng):
    params = vit.init_params(jax.random.key(0), SMALL)
    with pytest.raises(AssertionError):
        vit.forward(params, jnp.zeros((2, 3, 16, 16)), SMALL)


def test_bf16_forward_runs(rng):
    cfg = SMALL.replace(dtype=jnp.bfloat16)
    params = vit.init_params(jax.random.key(0), cfg)
    out = vit.forward(params, _pixels(rng, cfg), cfg)
    assert out.dtype == jnp.bfloat16
    assert np.isfinite(np.asarray(out, dtype=np.float32)).all()
