"""Int8 quantized inference tier (vit_tpu/quant.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_tpu import quant
from vit_tpu.config import ViTConfig
from vit_tpu.models import vit
from vit_tpu.models.vit import forward

SMALL = ViTConfig(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
                  num_layers=2, mlp_dim=128)


def test_quantize_weight_roundtrip(rng):
    w = jnp.asarray(rng.standard_normal((3, 96, 64)), jnp.float32)
    qw = quant.quantize_weight(w)
    assert qw["q"].dtype == jnp.int8 and qw["q"].shape == w.shape
    assert qw["scale"].shape == (3, 64)
    deq = qw["q"].astype(jnp.float32) * qw["scale"][:, None, :]
    # max error bounded by half a quantization step per channel
    err = jnp.max(jnp.abs(deq - w), axis=-2)
    assert float(jnp.max(err / qw["scale"])) <= 0.5 + 1e-3


def test_int8_matmul_close_to_float(rng):
    x = jnp.asarray(rng.standard_normal((4, 24, 96)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((96, 64)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((64,)), jnp.float32)
    got = quant.int8_matmul(x, quant.quantize_weight(w), b)
    want = x @ w + b
    rel = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
    assert rel < 2e-2, rel


def test_int8_matmul_zero_rows_stay_zero(rng):
    # Padded sequence rows are exact zeros — they must not NaN via the
    # dynamic activation scale.
    x = jnp.zeros((2, 8, 96), jnp.float32)
    w = quant.quantize_weight(jnp.asarray(rng.standard_normal((96, 64)),
                                          jnp.float32))
    out = quant.int8_matmul(x, w)
    np.testing.assert_array_equal(np.asarray(out), 0.0)


def test_forward_quant_matches_float(rng):
    params = vit.init_params(jax.random.key(0), SMALL)
    qparams = quant.quantize_params(params)
    px = jnp.asarray(rng.standard_normal((2, 3, 32, 32)), jnp.float32)
    got = np.asarray(jax.jit(quant.make_forward_quant(SMALL, jit=False))(
        qparams, px), np.float32)
    want = np.asarray(forward(params, px, SMALL), np.float32)
    assert got.shape == want.shape == (2, SMALL.seq_len, 64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-2, rel


def test_forward_quant_logits_correlate(rng):
    cfg = ViTConfig(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
                    num_layers=2, mlp_dim=128, num_classes=16)
    params = vit.init_params(jax.random.key(1), cfg)
    qparams = quant.quantize_params(params)
    px = jnp.asarray(rng.standard_normal((4, 3, 32, 32)), jnp.float32)
    got = np.asarray(quant.forward_quant(qparams, px, cfg), np.float64)
    want = np.asarray(forward(params, px, cfg), np.float64)
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.999, corr


@pytest.mark.slow
def test_forward_quant_golden_b16(tmp_path):
    # Full-scale accuracy pin: synthetic-golden ViT-B/16 weights through the
    # real import path, int8 forward vs float forward.
    from safetensors.numpy import save_file

    from vit_tpu.weights.checkpoint import params_from_safetensors
    from vit_tpu.weights.synthetic import golden_pixels, synthetic_hf_state_dict

    cfg = ViTConfig()
    sd = synthetic_hf_state_dict(cfg, seed=7)
    st = tmp_path / "b16.safetensors"
    save_file(sd, str(st))
    params = params_from_safetensors(str(st), cfg)
    px = jnp.asarray(golden_pixels(cfg, seed=3))

    want = np.asarray(forward(params, px, cfg), np.float64)
    got = np.asarray(quant.forward_quant(quant.quantize_params(params), px,
                                         cfg), np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert rel < 5e-2, rel
    assert corr > 0.999, corr


def test_quant_predictor_single_and_mesh(rng):
    from vit_tpu.parallel import make_mesh
    from vit_tpu.serving import Predictor

    cfg = ViTConfig(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
                    num_layers=2, mlp_dim=128, num_classes=8)
    params = vit.init_params(jax.random.key(0), cfg)
    imgs = np.asarray(rng.standard_normal((5, 3, 32, 32)), np.float32)

    single = Predictor(params, cfg, buckets=(2, 4), quant=True)
    out = np.asarray(single(imgs), np.float32)
    assert out.shape == (5, 8) and np.isfinite(out).all()

    mesh = make_mesh(data=8, model=1)
    dp = Predictor(params, cfg, buckets=(8,), mesh=mesh, quant=True)
    out_dp = np.asarray(dp(imgs), np.float32)
    np.testing.assert_allclose(out_dp, out, rtol=0, atol=1e-5)


def test_smooth_params_is_float_identity_and_helps_int8(rng):
    # The fold is exact for the float model; after quantization it should
    # not hurt (and typically helps) the xla act-quant tier's error.
    params = vit.init_params(jax.random.key(3), SMALL)
    px = jnp.asarray(rng.standard_normal((2, 3, 32, 32)), jnp.float32)

    smoothed = quant.smooth_params(params, SMALL, px)
    a = np.asarray(forward(params, px, SMALL), np.float64)
    b = np.asarray(forward(smoothed, px, SMALL), np.float64)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)  # float identity

    err_base = np.linalg.norm(np.asarray(
        quant.forward_quant(quant.quantize_params(params), px, SMALL),
        np.float64) - a)
    err_smooth = np.linalg.norm(np.asarray(
        quant.forward_quant(quant.quantize_params(smoothed), px, SMALL),
        np.float64) - a)
    assert err_smooth <= err_base * 1.1, (err_smooth, err_base)


def test_quantized_params_checkpoint_roundtrip(tmp_path, rng):
    # Int8 pytrees ride the same safetensors checkpoint path: int8 leaves
    # and fp32 scales keep their dtypes, forward output is identical.
    from vit_tpu.weights import checkpoint as ckpt

    params = vit.init_params(jax.random.key(0), SMALL)
    qparams = quant.quantize_params(params)
    path = str(tmp_path / "q")
    ckpt.save_params(path, qparams, SMALL)
    loaded, cfg2 = ckpt.load_params(path)
    assert cfg2 == SMALL
    k = loaded["encoder"]["qkv"]["kernel"]
    assert k["q"].dtype == jnp.int8 and k["scale"].dtype == jnp.float32

    px = jnp.asarray(rng.standard_normal((1, 3, 32, 32)), jnp.float32)
    a = np.asarray(quant.forward_quant(qparams, px, SMALL), np.float32)
    b = np.asarray(quant.forward_quant(loaded, px, SMALL), np.float32)
    np.testing.assert_array_equal(a, b)


def test_forward_quant_bf16(rng):
    # The int8 tier runs in a bf16 activation model too (the production
    # dtype): finite, close to the bf16 float forward.
    cfg = SMALL.replace(dtype=jnp.bfloat16)
    params = vit.init_params(jax.random.key(0), cfg)
    qparams = quant.quantize_params(params)
    px = jnp.asarray(rng.standard_normal((2, 3, 32, 32)), jnp.bfloat16)
    got = np.asarray(quant.forward_quant(qparams, px, cfg), np.float32)
    want = np.asarray(forward(params, px, cfg), np.float32)
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 6e-2, rel


def test_quant_accuracy_report_flip_rate_and_smoothquant_win():
    """Task-level int8 accuracy (VERDICT r2 #5): on the tiny synthetic
    model with a classifier head, the full int8 tier keeps top-1 agreement
    with the float model >= 95% on plain weights, and on the outlier-
    channel stress case SmoothQuant measurably beats plain w8a8 (lower
    hidden error, no worse top-1 agreement). Full-size B/16 numbers:
    tools/quant_accuracy.py + docs/QUANT.md."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools.quant_accuracy import main as qacc_main

    rows = qacc_main(["--tiny", "--batch", "16", "--classes", "64"])
    by = {(r["case"].split()[0], r["tier"]): r for r in rows}
    assert by[("plain", "w8a8")]["top1_agreement"] >= 0.95
    assert by[("plain", "w8a8")]["hidden_rel_err"] < 0.03
    stress, smooth = by[("outlier", "w8a8")], by[("outlier", "w8a8+smooth")]
    assert smooth["hidden_rel_err"] < stress["hidden_rel_err"]
    assert smooth["top1_agreement"] >= stress["top1_agreement"]


def _np_int8_matmul(x, wq, bias=None, activation=None):
    """Float64 oracle of the int8 tier's matmul: per-row symmetric
    activation quant (round half to even, like jnp.round), int8 x int8 dot,
    rescale by both scales."""
    import np_oracle as O

    x = O.f64(x)
    ax = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-12)
    xq = np.clip(np.round(x / ax), -127, 127)
    y = (xq @ O.f64(wq["q"])) * ax * O.f64(wq["scale"])
    if bias is not None:
        y = y + O.f64(bias)
    return O.gelu(y) if activation == "gelu" else y


@pytest.mark.parametrize("shape", [(4, 24, 96), (2, 197, 768)])
@pytest.mark.parametrize("n", [64, 3072])
@pytest.mark.parametrize("bias,act", [(False, None), (True, None),
                                      (True, "gelu")])
def test_int8_matmul_matches_oracle(rng, shape, n, bias, act):
    # Same quantization decisions as the float64 oracle -> agreement to
    # fp32 rounding of the rescale (int32 accumulation is exact here). An
    # activation landing within fp32 rounding of a .5 code boundary may
    # round the other way; at most a 1e-3 share of outputs may feel that.
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    wq = quant.quantize_weight(
        jnp.asarray(rng.standard_normal((shape[-1], n)) * 0.05, jnp.float32))
    b = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.float32) if bias else None
    got = np.asarray(quant.int8_matmul(x, wq, b, act), np.float64)
    want = _np_int8_matmul(x, wq, b, act)
    assert got.shape == shape[:-1] + (n,)
    off = np.abs(got - want) > 1e-4
    assert off.mean() < 1e-3, (off.mean(), np.abs(got - want).max())


def test_forward_quant_block_matches_oracle(rng):
    # One int8 block end to end vs a float64 oracle of the same math: LN ->
    # int8 QKV -> float attention -> int8 out-proj -> LN -> int8 fc1+GELU
    # -> int8 fc2, residuals in float.
    import np_oracle as O

    cfg = SMALL.replace(num_layers=1)
    params = vit.init_params(jax.random.key(4), cfg)
    qp = quant.quantize_params(params)
    x = jnp.asarray(rng.standard_normal((2, cfg.seq_len, 64)), jnp.float32)
    lp = jax.tree.map(lambda a: a[0], qp["encoder"])
    got = np.asarray(quant._block_quant(x, lp, cfg), np.float64)

    b, s, d = x.shape
    h = O.layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
    qkv = _np_int8_matmul(h, lp["qkv"]["kernel"], lp["qkv"]["bias"])
    qkv = qkv.reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
    ctx = O.attention_bshd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    y = O.f64(x) + _np_int8_matmul(ctx.reshape(b, s, d),
                                   lp["out"]["kernel"], lp["out"]["bias"])
    h = O.layernorm(y, lp["ln2"]["scale"], lp["ln2"]["bias"])
    h = _np_int8_matmul(h, lp["fc1"]["kernel"], lp["fc1"]["bias"], "gelu")
    want = y + _np_int8_matmul(h, lp["fc2"]["kernel"], lp["fc2"]["bias"])
    # Rounding boundaries may flip a few activation codes between fp32 and
    # float64 inputs: one int8 step of one row, far below the 5e-2
    # relative bar of the tier.
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel
