"""Int8 quantized inference tier — a capability beyond the reference.

Weight-and-activation symmetric int8 for every encoder matmul (QKV,
attention output projection, fc1, fc2): weights are quantized offline
per output channel, activations dynamically per row at trace time, and
the dot runs int8 x int8 -> int32. The int8 weight stream is half the bf16
weight traffic that bounds the small-batch latency regime; whether XLA
lowers the s8 x s8 -> s32 dot to the GPU's int8 tensor cores is a question
for the card (PERF.md).

Everything accuracy-critical or cheap stays in float: LayerNorm, softmax,
GELU, residuals, the attention score/context dots (their operands are
activations x activations — per-row scaling cannot be folded into a
weight), patch embedding, and the classifier head.

The reference has no quantization story (fp32-only, reference
vit/vit.py:22-23); this module extends its "make inference fast" goal. The
op tier is XLA (jnp): ``lax.dot_general`` with int8 operands and
``preferred_element_type=int32``; a fused low-precision kernel can slot in
behind the same pytree later.

Accuracy (synthetic-golden ViT-B/16 weights, tests/test_quant.py): final
hidden states match the float forward to ~2% relative error (corr 0.9998).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp

from vit_tpu import ops
from vit_tpu.config import ViTConfig
from vit_tpu.models.vit import Params, embed
from vit_tpu.ops import reference as ref

QParams = dict[str, Any]

_QMAX = 127.0


def quantize_weight(w: jax.Array) -> QParams:
    """Per-output-channel symmetric int8: ``w (..., K, N)`` -> int8 ``q``
    of the same shape + fp32 ``scale (..., N)`` with ``q * scale ≈ w``."""
    w32 = jnp.asarray(w, jnp.float32)
    scale = jnp.max(jnp.abs(w32), axis=-2) / _QMAX
    scale = jnp.maximum(scale, 1e-12)
    q = jnp.round(w32 / scale[..., None, :])
    return {"q": jnp.clip(q, -_QMAX, _QMAX).astype(jnp.int8),
            "scale": scale}


def quantize_params(params: Params) -> Params:
    """Quantize the encoder matmul weights of a float params pytree.

    Returns a new pytree in which each of ``encoder.{qkv,out,fc1,fc2}``
    has its ``kernel`` replaced by ``{"q": int8, "scale": fp32}`` (stacked
    layer axis preserved). Everything else (embeddings, LNs, biases,
    classifier) is passed through unchanged, so the result feeds
    :func:`forward_quant` directly.
    """
    out = dict(params)
    enc = dict(params["encoder"])
    for name in ("qkv", "out", "fc1", "fc2"):
        p = enc[name]
        enc[name] = {"kernel": quantize_weight(p["kernel"]),
                     "bias": p["bias"]}
    out["encoder"] = enc
    return out


def int8_matmul(x: jax.Array, wq: QParams, bias: jax.Array | None = None,
                activation: str | None = None) -> jax.Array:
    """``(..., M, K) @ int8 (K, N)`` with dynamic per-row activation quant.

    ``y = (round(x / ax) . q) * ax * scale + bias`` where ``ax`` is each
    row's max-abs / 127. The dot itself is int8 x int8 -> int32; the
    rescale is a rank-1 outer product fused into the epilogue by XLA.
    """
    x32 = jnp.asarray(x, jnp.float32)
    ax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / _QMAX
    ax = jnp.maximum(ax, 1e-12)  # zero rows (e.g. seq padding) stay zero
    xq = jnp.round(x32 / ax).astype(jnp.int8)
    acc = jax.lax.dot_general(
        xq, wq["q"], (((xq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * ax * wq["scale"]
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    if activation == "gelu":
        y = ref.gelu(y)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y.astype(x.dtype)


def smooth_params(params: Params, cfg: ViTConfig, pixels: jax.Array,
                  alpha: float = 0.5) -> Params:
    """SmoothQuant-style outlier migration for the LN-fed matmuls.

    Per input channel j of the QKV and fc1 projections, pick
    ``c_j = amax_act_j**alpha / amax_w_j**(1-alpha)`` (calibrated on
    ``pixels`` through the float model) and rewrite

        LN_scale /= c,  LN_bias /= c,  W[j, :] *= c_j

    — exactly identity for the float model (asserted by tests), but the
    activation rows the int8 tier quantizes dynamically become flatter, so
    per-row int8 loses less to channel outliers. The out/fc2 projections
    have nonlinear producers (attention, GELU) and are left untouched.

    Measured: ~1% error reduction on well-conditioned synthetic weights
    (tests); the technique's real payoff is pretrained checkpoints with
    outlier channels (the LLM.int8/SmoothQuant observation), where
    activation-quant error is outlier-dominated.
    """
    from vit_tpu.models.vit import forward_with_intermediates

    _, hiddens = forward_with_intermediates(params, pixels, cfg)
    enc = {k: dict(v) for k, v in params["encoder"].items()}

    def fold(ln_name, w_name, act_amax):
        ln, w = dict(enc[ln_name]), dict(enc[w_name])
        w_amax = jnp.max(jnp.abs(w["kernel"].astype(jnp.float32)), axis=-1)
        c = (jnp.maximum(act_amax, 1e-6) ** alpha
             / jnp.maximum(w_amax, 1e-6) ** (1 - alpha))
        c = jnp.maximum(c, 1e-6)
        dt = ln["scale"].dtype
        ln["scale"] = (ln["scale"].astype(jnp.float32) / c).astype(dt)
        ln["bias"] = (ln["bias"].astype(jnp.float32) / c).astype(dt)
        w["kernel"] = (w["kernel"].astype(jnp.float32)
                       * c[..., None]).astype(w["kernel"].dtype)
        enc[ln_name], enc[w_name] = ln, w

    # Per-layer amax of each LN's output (the matmul input): ln1 sees the
    # block input, ln2 sees the post-attention activation — recompute it
    # from the captured block inputs with the float attention half.
    eps = cfg.layernorm_eps
    ln1_amax, ln2_amax = [], []
    for l in range(cfg.num_layers):
        lp = jax.tree.map(lambda a: a[l], params["encoder"])
        x = hiddens[l]
        xn = ref.layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps=eps)
        ln1_amax.append(jnp.max(jnp.abs(xn.astype(jnp.float32)),
                                axis=(0, 1)))
        b_, s_, d_ = x.shape
        nh, hd = cfg.num_heads, cfg.head_dim
        qkv = ref.matmul(xn, lp["qkv"]["kernel"], lp["qkv"]["bias"])
        qkv = qkv.reshape(b_, s_, 3, nh, hd)
        ctx = ops.attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                            scale=hd ** -0.5).reshape(b_, s_, d_)
        xa = x + ref.matmul(ctx, lp["out"]["kernel"], lp["out"]["bias"])
        xn2 = ref.layernorm(xa, lp["ln2"]["scale"], lp["ln2"]["bias"],
                            eps=eps)
        ln2_amax.append(jnp.max(jnp.abs(xn2.astype(jnp.float32)),
                                axis=(0, 1)))

    fold("ln1", "qkv", jnp.stack(ln1_amax))
    fold("ln2", "fc1", jnp.stack(ln2_amax))
    out = dict(params)
    out["encoder"] = enc
    return out


def _block_quant(x: jax.Array, lp: Params, cfg: ViTConfig) -> jax.Array:
    """One pre-LN block with int8 projections (float attention core on the
    same route as the float model, :func:`vit_tpu.ops.attention`)."""
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    eps = cfg.layernorm_eps

    xn = ref.layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps=eps)
    qkv = int8_matmul(xn, lp["qkv"]["kernel"], lp["qkv"]["bias"])
    qkv = qkv.reshape(b, s, 3, nh, hd)
    ctx = ops.attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                        scale=hd ** -0.5)
    x = x + int8_matmul(ctx.reshape(b, s, d), lp["out"]["kernel"],
                        lp["out"]["bias"])

    xn = ref.layernorm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps=eps)
    h = int8_matmul(xn, lp["fc1"]["kernel"], lp["fc1"]["bias"],
                    activation="gelu")
    return x + int8_matmul(h, lp["fc2"]["kernel"], lp["fc2"]["bias"])


def forward_quant(qparams: Params, pixels: jax.Array,
                  cfg: ViTConfig) -> jax.Array:
    """ViT forward on int8-quantized encoder weights.

    Same contract as :func:`vit_tpu.models.vit.forward` (hidden states,
    pooled embedding, or logits per ``cfg``); ``qparams`` comes from
    :func:`quantize_params`.
    """
    x = embed(qparams, pixels, cfg)

    def body(x, lp):
        return _block_quant(x, lp, cfg), None

    x, _ = jax.lax.scan(body, x, qparams["encoder"])
    x = ref.layernorm(x, qparams["ln_final"]["scale"],
                      qparams["ln_final"]["bias"], eps=cfg.layernorm_eps)

    if cfg.num_classes:
        pooled = x[:, 0] if cfg.pooling in ("none", "cls") else jnp.mean(x, axis=1)
        c = qparams["classifier"]
        return pooled @ c["kernel"].astype(pooled.dtype) + c["bias"]
    if cfg.pooling == "cls":
        return x[:, 0]
    if cfg.pooling == "mean":
        return jnp.mean(x, axis=1)
    return x


def make_forward_quant(cfg: ViTConfig, *, jit: bool = True):
    """Bind config (and optionally jit) — mirror of ``make_forward``."""
    fn = functools.partial(forward_quant, cfg=cfg)
    return jax.jit(fn) if jit else fn
