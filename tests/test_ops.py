"""The op library as the model runs it, against the float64 NumPy oracle.

Aligned AND unaligned (197-, 257- and 577-token) shapes, both dtypes, head
dim 80, zero-padded batches and DeiT's two prefix tokens — the per-kernel allclose
testing the reference does in each kernel's ``__main__`` (SURVEY.md §4),
as a real pytest suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import np_oracle as O
from vit_tpu import ops
from vit_tpu.config import ViTConfig
from vit_tpu.models import vit

F32, BF16 = jnp.float32, jnp.bfloat16


def _tol(dt, f32_tol, bf16_tol):
    return f32_tol if dt == F32 else bf16_tol


def _rand(rng, shape, dt, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, dt)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=atol,
                               rtol=0)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("shape", [(2, 197, 768), (4, 50, 100), (8, 1280)])
def test_layernorm(rng, dt, shape):
    x = _rand(rng, shape, dt)
    s = _rand(rng, shape[-1:], F32)
    b = _rand(rng, shape[-1:], F32)
    got = ops.layernorm(x, s, b, eps=1e-12)
    assert got.dtype == dt
    _close(got, O.layernorm(x, s, b, 1e-12), _tol(dt, 2e-5, 8e-2))


def test_layernorm_row_statistics(rng):
    # Unit scale, zero bias: every output row has mean 0 and biased
    # variance 1 (eps inside the sqrt is negligible at this scale).
    x = _rand(rng, (2, 37, 100), F32, scale=3.0) + 5.0
    y = np.asarray(ops.layernorm(x, jnp.ones(100), jnp.zeros(100)),
                   np.float64)
    np.testing.assert_allclose(y.mean(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(y.var(-1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("shape", [(2, 197, 197), (24, 197, 64),
                                   (4, 16, 300)])
def test_softmax(rng, dt, shape):
    x = _rand(rng, shape, dt, scale=10.0)
    got = ops.softmax(x)
    assert got.dtype == dt
    _close(got, O.softmax(x), _tol(dt, 1e-6, 1e-2))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("shape", [(64,), (2, 197, 3072)])
def test_gelu(rng, dt, shape):
    x = _rand(rng, shape, dt, scale=3.0)
    _close(ops.gelu(x), O.gelu(x), _tol(dt, 1e-5, 4e-2))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("m,k,n", [(197, 768, 3072), (100, 588, 64),
                                   (256, 256, 256)])
@pytest.mark.parametrize("bias,act", [(False, None), (True, None),
                                      (True, "gelu")])
def test_matmul(rng, dt, m, k, n, bias, act):
    x = _rand(rng, (2, m, k), dt, scale=0.1)
    w = _rand(rng, (k, n), dt, scale=0.1)
    b = _rand(rng, (n,), dt, scale=0.1) if bias else None
    got = ops.matmul(x, w, b, act)
    assert got.shape == (2, m, n) and got.dtype == dt
    _close(got, O.linear(x, w, b, act), _tol(dt, 1e-4, 5e-2))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("m,k,n", [(197, 768, 768), (64, 100, 52)])
@pytest.mark.parametrize("ln,res,act", [
    (True, False, None), (False, True, None), (True, True, "gelu"),
    (False, False, "gelu"),
])
def test_linear_chain(rng, dt, m, k, n, ln, res, act):
    # LN -> matmul(+bias, GELU) -> +residual: the chain XLA fuses into the
    # GEMMs of every encoder block (models/vit.py:encoder_block).
    x = _rand(rng, (2, m, k), dt)
    w = _rand(rng, (k, n), dt, scale=0.05)
    b = _rand(rng, (n,), dt, scale=0.05)
    ln_s = _rand(rng, (k,), dt) if ln else None
    ln_b = _rand(rng, (k,), dt) if ln else None
    r = _rand(rng, (2, m, n), dt) if res else None

    def chain(x, w, b, ln_s, ln_b, r):
        h = ops.layernorm(x, ln_s, ln_b) if ln else x
        out = ops.matmul(h, w, b, act)
        return out + r if res else out

    got = jax.jit(chain)(x, w, b, ln_s, ln_b, r)
    h = O.layernorm(x, ln_s, ln_b) if ln else O.f64(x)
    want = O.linear(h, w, b, act) + (O.f64(r) if res else 0.0)
    _close(got, want, _tol(dt, 1e-4, 1.5e-1))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("s", [197, 256, 577, 50])
def test_attention(rng, dt, s):
    shape = (2, s, 4, 64)  # (B, S, H, d)
    q, k, v = (_rand(rng, shape, dt) for _ in range(3))
    got = ops.attention(q, k, v)
    assert got.shape == shape and got.dtype == dt
    _close(got, O.attention_bshd(q, k, v), _tol(dt, 2e-5, 2e-2))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_attention_head_dim_80(rng, dt):
    # H/14 head dim (1280/16 = 80) at its 257 tokens.
    shape = (1, 257, 2, 80)
    q, k, v = (_rand(rng, shape, dt) for _ in range(3))
    _close(ops.attention(q, k, v), O.attention_bshd(q, k, v),
           _tol(dt, 2e-5, 2e-2))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("b,s,h,d", [(2, 197, 12, 64), (1, 50, 12, 64),
                                     (2, 128, 4, 32)])
@pytest.mark.parametrize("scale", [None, 0.125])
def test_attention_scale(rng, dt, b, s, h, d, scale):
    q, k, v = (_rand(rng, (b, s, h, d), dt, scale=0.3) for _ in range(3))
    got = ops.attention(q, k, v, scale=scale)
    _close(got, O.attention_bshd(q, k, v, scale), _tol(dt, 2e-5, 2e-2))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("s", [197, 50, 577])
def test_attention_zero_padded_batch(rng, dt, s):
    # The padding the program does: Predictor fills a bucket with zero
    # images. Real rows are unchanged by the pad rows, and pad rows stay
    # finite (all-equal scores -> uniform softmax, no 0/0).
    shape = (2, s, 4, 64)  # (B, S, H, d)
    q, k, v = (_rand(rng, shape, dt) for _ in range(3))
    pad = ((0, 3), (0, 0), (0, 0), (0, 0))
    got = ops.attention(*(jnp.pad(a, pad) for a in (q, k, v)))
    _close(got[:2], O.attention_bshd(q, k, v), _tol(dt, 2e-5, 2e-2))
    np.testing.assert_array_equal(np.asarray(got[2:], np.float32), 0.0)


@pytest.mark.parametrize("platform,dtype,route", [
    ("gpu", BF16, "cudnn"), ("gpu", jnp.float16, "cudnn"),
    ("gpu", F32, "xla"), ("cpu", BF16, "xla"), ("cpu", F32, "xla"),
    ("cpu", jnp.float16, "xla"),
])
def test_attention_route(platform, dtype, route):
    # Chosen from platform and dtype alone: fp32 keeps the plain chain at
    # HIGHEST precision everywhere; half precision goes to cuDNN on a GPU.
    assert ops.attention_route(dtype, platform) == route


@pytest.mark.parametrize("h,p,c", [(224, 16, 3), (32, 16, 3), (28, 14, 4)])
def test_patching(rng, h, p, c):
    x = _rand(rng, (2, c, h, h), F32)
    np.testing.assert_array_equal(np.asarray(ops.patchify(x, p)),
                                  O.patchify(x, p))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("h,p,d", [(224, 16, 768), (28, 14, 80)])
def test_patch_embed(rng, dt, h, p, d):
    c = 3
    x = _rand(rng, (2, c, h, h), dt)
    w = _rand(rng, (c * p * p, d), dt, scale=0.05)
    b = _rand(rng, (d,), dt, scale=0.05)
    got = ops.patch_embed(x, w, b, p)
    assert got.shape == (2, (h // p) ** 2, d)
    _close(got, O.linear(O.patchify(x, p), w, b), _tol(dt, 1e-4, 5e-2))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("geom", [
    dict(image_size=224, patch_size=16, hidden_dim=768, num_heads=12),
    dict(image_size=28, patch_size=14, hidden_dim=80, num_heads=1),
    dict(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
         num_prefix_tokens=2),
])
def test_embed(rng, dt, geom):
    # Patch projection + prefix token(s) + learned positions (reference
    # vit/vit.py:188-200), including DeiT's CLS + distillation tokens.
    cfg = ViTConfig(num_layers=1, mlp_dim=4 * geom["hidden_dim"], dtype=dt,
                    **geom)
    params = vit.init_params(jax.random.key(0), cfg)
    px = _rand(rng, (2, 3, cfg.image_size, cfg.image_size), F32)
    got = vit.embed(params, px, cfg)
    assert got.shape == (2, cfg.seq_len, cfg.hidden_dim) and got.dtype == dt
    _close(got, O.embed(params, px.astype(dt), cfg), _tol(dt, 1e-4, 5e-2))
