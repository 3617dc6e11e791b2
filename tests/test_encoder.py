"""The encoder as the program runs it — one block, the whole forward and
the per-layer capture — against the float64 NumPy oracle (np_oracle.py).

Geometries cover the odd shapes the variants use: 197 tokens, head dim 80
(H/14), 50 tokens (B/32) and DeiT's two prefix tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import np_oracle as O
from vit_tpu.config import ViTConfig
from vit_tpu.models import vit

F32, BF16 = jnp.float32, jnp.bfloat16

GEOMS = {
    "tiny": dict(image_size=32, patch_size=16, hidden_dim=48, num_heads=4,
                 mlp_dim=96),
    "s197": dict(image_size=224, patch_size=16, hidden_dim=64, num_heads=4,
                 mlp_dim=128),
    "hd80": dict(image_size=56, patch_size=14, hidden_dim=160, num_heads=2,
                 mlp_dim=320),
    "deit": dict(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
                 mlp_dim=128, num_prefix_tokens=2),
}

# bf16 keeps 8 mantissa bits; these activations are O(1) after each LN, so
# a block lands within a few 1e-2 of the float64 oracle and two blocks plus
# the final LN within ~1e-1.
TOL = {F32: 5e-5, BF16: 6e-2}
FWD_TOL = {F32: 5e-5, BF16: 1.5e-1}


def _cfg(geom, dt, **kw):
    return ViTConfig(num_layers=2, dtype=dt, **{**GEOMS[geom], **kw})


def _px(rng, cfg, b=2):
    return jnp.asarray(rng.standard_normal(
        (b, 3, cfg.image_size, cfg.image_size)), jnp.float32)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_encoder_block_matches_oracle(rng, dt, geom):
    cfg = _cfg(geom, dt)
    params = vit.init_params(jax.random.key(1), cfg)
    # LN params away from (1, 0) so a swapped scale/bias would show.
    params["encoder"]["ln1"]["scale"] = params["encoder"]["ln1"]["scale"] * 1.3
    params["encoder"]["ln2"]["bias"] = params["encoder"]["ln2"]["bias"] + 0.1
    x = jnp.asarray(rng.standard_normal((2, cfg.seq_len, cfg.hidden_dim)), dt)
    lp = jax.tree.map(lambda a: a[0], params["encoder"])
    got = jax.jit(lambda x, lp: vit.encoder_block(x, lp, cfg))(x, lp)
    assert got.shape == x.shape and got.dtype == dt
    want = O.block(x, O.layer(params, 0), cfg)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("head", [
    dict(), dict(pooling="cls"), dict(pooling="mean"), dict(num_classes=10),
])
def test_forward_matches_oracle(rng, dt, head):
    cfg = _cfg("tiny", dt, **head)
    params = vit.init_params(jax.random.key(2), cfg)
    px = _px(rng, cfg)
    got = vit.make_forward(cfg)(params, px)
    want = O.forward(params, px.astype(dt), cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=FWD_TOL[dt], rtol=0)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_forward_with_intermediates_matches_oracle(rng, dt):
    cfg = _cfg("s197", dt)
    params = vit.init_params(jax.random.key(3), cfg)
    px = _px(rng, cfg)
    final, hiddens = vit.forward_with_intermediates(params, px, cfg)
    want_final, want_hiddens = O.forward_with_hiddens(params, px.astype(dt),
                                                      cfg)
    assert len(hiddens) == cfg.num_layers + 1
    for got, want in zip(hiddens, want_hiddens):
        np.testing.assert_allclose(np.asarray(got, np.float64), want,
                                   atol=FWD_TOL[dt], rtol=0)
    np.testing.assert_allclose(np.asarray(final, np.float64), want_final,
                               atol=FWD_TOL[dt], rtol=0)


def test_forward_jit_matches_eager(rng):
    cfg = _cfg("hd80", F32)
    params = vit.init_params(jax.random.key(4), cfg)
    px = _px(rng, cfg, b=1)
    np.testing.assert_allclose(np.asarray(vit.make_forward(cfg)(params, px)),
                               np.asarray(vit.forward(params, px, cfg)),
                               atol=1e-5, rtol=0)
