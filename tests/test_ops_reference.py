"""Golden tests for the pure-jnp oracle ops against manual numpy semantics.

These pin down the exact numerics every route of the op library must
reproduce (the role torch plays for the reference's kernel self-tests,
SURVEY.md §4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import special

from vit_tpu.ops import reference as R


def test_gelu_is_exact_erf_form(rng):
    # erf form, NOT tanh approximation (reference vit/kernels/activations.py:8-20)
    x = rng.standard_normal((64,)).astype(np.float32)
    want = 0.5 * x * (1.0 + special.erf(x / np.sqrt(2.0)))
    np.testing.assert_allclose(R.gelu(jnp.asarray(x)), want, atol=1e-6)


def test_layernorm_biased_var_eps_inside_sqrt(rng):
    # Semantics pinned at reference vit/kernels/layernorm.py:72-73.
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    eps = 1e-12
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)  # biased
    want = (x - mu) / np.sqrt(var + eps) * scale + bias
    got = R.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), eps=eps)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_softmax_rows_sum_to_one_and_stable(rng):
    x = rng.standard_normal((3, 4, 37)).astype(np.float32) * 50  # large values
    got = np.asarray(R.softmax(jnp.asarray(x)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    e = np.exp(x - x.max(-1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(-1, keepdims=True), atol=1e-6)


def test_matmul_fused_bias_gelu(rng):
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    base = x @ w
    np.testing.assert_allclose(R.matmul(jnp.asarray(x), jnp.asarray(w)),
                               base, atol=1e-5)
    np.testing.assert_allclose(
        R.matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
        base + b, atol=1e-5)
    want = np.asarray(R.gelu(jnp.asarray(base + b)))
    np.testing.assert_allclose(
        R.matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), "gelu"),
        want, atol=1e-5)
    with pytest.raises(ValueError):
        R.matmul(jnp.asarray(x), jnp.asarray(w), activation="relu")


def test_patchify_matches_manual_unfold(rng):
    # Per-patch element order (channel, row, col); patches row-major —
    # the torch.nn.Unfold convention (reference vit/kernels/patching.py:95-105).
    b, c, h, w, p = 2, 3, 8, 8, 4
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    got = np.asarray(R.patchify(jnp.asarray(x), p))
    assert got.shape == (b, (h // p) * (w // p), c * p * p)
    for bi in range(b):
        n = 0
        for i in range(h // p):
            for j in range(w // p):
                patch = x[bi, :, i * p:(i + 1) * p, j * p:(j + 1) * p]
                np.testing.assert_array_equal(got[bi, n], patch.reshape(-1))
                n += 1


def test_patch_embed_equals_conv2d(rng):
    # unfold+matmul == non-overlapping conv (reference vit/kernels/conv2d.py).
    import torch

    b, c, h, p, d = 2, 3, 16, 8, 10
    x = rng.standard_normal((b, c, h, h)).astype(np.float32)
    conv = torch.nn.Conv2d(c, d, kernel_size=p, stride=p)
    w = conv.weight.detach().numpy()          # (D, C, P, P)
    bias = conv.bias.detach().numpy()
    with torch.no_grad():
        want = conv(torch.from_numpy(x))      # (B, D, H/P, W/P)
    want = want.flatten(2).transpose(1, 2).numpy()  # HF layout (vit/vit.py:192)

    kernel = jnp.asarray(w.reshape(d, c * p * p).T)
    got = R.patch_embed(jnp.asarray(x), kernel, jnp.asarray(bias), p)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_attention_matches_unfused_chain(rng):
    b, nh, s, hd = 2, 3, 9, 8
    q = rng.standard_normal((b, nh, s, hd)).astype(np.float32)
    k = rng.standard_normal((b, nh, s, hd)).astype(np.float32)
    v = rng.standard_normal((b, nh, s, hd)).astype(np.float32)
    got = np.asarray(R.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(hd)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bhkd->bhqd", probs, v)
    np.testing.assert_allclose(got, want, atol=1e-5)
