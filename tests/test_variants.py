"""All five BASELINE.json model variants run end to end (CPU).

Exercises the odd geometries: B/32's 3072-wide patch vectors, L/16-384's
577 tokens, H/14's 588-wide (unaligned) patch vectors + head_dim 80 +
pooled output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_tpu.config import VARIANTS
from vit_tpu.models import vit


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_forward_xla(name, rng):
    cfg = VARIANTS[name].replace(num_layers=2)  # depth-trimmed: geometry test
    params = vit.init_params(jax.random.key(0), cfg)
    px = jnp.asarray(rng.standard_normal(
        (1, 3, cfg.image_size, cfg.image_size)), jnp.float32)
    out = vit.forward(params, px, cfg)
    want = (1, cfg.hidden_dim) if cfg.pooling == "cls" \
        else (1, cfg.seq_len, cfg.hidden_dim)
    assert out.shape == want
    assert np.isfinite(np.asarray(out)).all()
