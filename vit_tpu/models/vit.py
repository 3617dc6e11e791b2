"""ViT forward graph — a single jit-compiled functional program.

This is the XLA-native redesign of the reference's torch module tree
(reference vit/vit.py:203-247: Embeddings -> Encoder -> final LayerNorm).
Key departures, all XLA-idiomatic rather than translations:

- **Functional params pytree** instead of ``nn.Module`` state: the whole
  forward is one traced program; there is no per-op dispatch (the reference
  pays ~1,100 kernel launches per forward, SURVEY.md §3.2 — here it is one
  XLA executable, subsuming its planned CUDA-graph fix, reference README.md:28).
- **Stacked layer parameters + ``lax.scan``** over the encoder depth instead
  of a Python loop over 12 module objects (reference vit/vit.py:167-169):
  compile time is O(1) in depth and XLA pipelines the layers.
- **Fused full-width QKV** ``(D, 3D)`` matmul and batched multi-head
  attention instead of the reference's Python loop over 12 single-head
  modules with slice-assign (reference vit/vit.py:101-106) — head
  parallelism becomes a GEMM batch dimension, and on the GPU the bf16
  attention is one fused cuDNN call (:func:`vit_tpu.ops.attention`).
- **Patch embedding as unfold+matmul** instead of the scalar-loop conv2d
  (reference vit/kernels/conv2d.py, its slowest kernel — SURVEY.md §6).

Numerical semantics are kept bit-compatible with the reference / HF ViT:
pre-LN blocks, LN eps 1e-12 inside the sqrt, exact erf-GELU, fp32
accumulation in every matmul, CLS + learned position embeddings, final LN,
no pooler (output (B, 197, 768) for B/16, like HF
``ViTModel(add_pooling_layer=False)`` — reference vit/vit.py:273).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp

from vit_tpu import ops
from vit_tpu.config import ViTConfig

Params = dict[str, Any]


def init_params(key: jax.Array, cfg: ViTConfig) -> Params:
    """Random-initialized params pytree (HF-style truncated-normal 0.02).

    Encoder leaves are stacked along a leading ``num_layers`` axis for
    ``lax.scan``.
    """
    d, l, m = cfg.hidden_dim, cfg.num_layers, cfg.mlp_dim
    keys = iter(jax.random.split(key, 16))
    dt = cfg.dtype

    def tn(k, shape, std=0.02):
        return (jax.random.truncated_normal(k, -2.0, 2.0, shape, jnp.float32)
                * std).astype(dt)

    params: Params = {
        "embeddings": {
            # Holds ALL learned prefix tokens (CLS for ViT; CLS +
            # distillation for DeiT, cfg.num_prefix_tokens == 2).
            "cls_token": tn(next(keys), (1, cfg.num_prefix_tokens, d)),
            "position_embeddings": tn(next(keys), (1, cfg.seq_len, d)),
            "patch_embed": {
                "kernel": tn(next(keys), (cfg.patch_dim, d)),
                "bias": jnp.zeros((d,), dt),
            },
        },
        "encoder": {
            "ln1": {"scale": jnp.ones((l, d), dt), "bias": jnp.zeros((l, d), dt)},
            "qkv": {"kernel": tn(next(keys), (l, d, 3 * d)),
                    "bias": jnp.zeros((l, 3 * d), dt)},
            "out": {"kernel": tn(next(keys), (l, d, d)),
                    "bias": jnp.zeros((l, d), dt)},
            "ln2": {"scale": jnp.ones((l, d), dt), "bias": jnp.zeros((l, d), dt)},
            "fc1": {"kernel": tn(next(keys), (l, d, m)),
                    "bias": jnp.zeros((l, m), dt)},
            "fc2": {"kernel": tn(next(keys), (l, m, d)),
                    "bias": jnp.zeros((l, d), dt)},
        },
        "ln_final": {"scale": jnp.ones((d,), dt), "bias": jnp.zeros((d,), dt)},
    }
    if cfg.num_classes:
        params["classifier"] = {
            "kernel": tn(next(keys), (d, cfg.num_classes)),
            "bias": jnp.zeros((cfg.num_classes,), dt),
        }
    return params


def embed(params: Params, pixels: jax.Array, cfg: ViTConfig) -> jax.Array:
    """Patch-embed + CLS + position embeddings (reference vit/vit.py:173-200).

    ``pixels``: (B, C, H, W) NCHW, any float dtype -> (B, seq_len, D).
    """
    b, c, h, w = pixels.shape
    assert (c, h, w) == (cfg.num_channels, cfg.image_size, cfg.image_size), (
        pixels.shape, cfg)
    e = params["embeddings"]
    dt = cfg.dtype
    x = ops.patch_embed(pixels.astype(dt), e["patch_embed"]["kernel"],
                        e["patch_embed"]["bias"], cfg.patch_size)
    cls = jnp.broadcast_to(e["cls_token"].astype(dt),
                           (b, cfg.num_prefix_tokens, cfg.hidden_dim))
    x = jnp.concatenate([cls, x], axis=1)
    return x + e["position_embeddings"].astype(dt)


def encoder_block(x: jax.Array, lp: Params, cfg: ViTConfig) -> jax.Array:
    """One pre-LN transformer block (reference vit/vit.py:114-149).

    ``lp`` holds this layer's slice of the stacked encoder params. XLA fuses
    each LayerNorm into the GEMM that reads it and each bias, GELU and
    residual add into the GEMM that produces it.
    """
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    eps = cfg.layernorm_eps

    h = ops.layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps=eps)
    qkv = ops.matmul(h, lp["qkv"]["kernel"], lp["qkv"]["bias"])
    qkv = qkv.reshape(b, s, 3, nh, hd)
    ctx = ops.attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                        scale=hd ** -0.5)
    # residual 1 (reference vit/vit.py:140)
    x = ops.matmul(ctx.reshape(b, s, d), lp["out"]["kernel"],
                   lp["out"]["bias"]) + x
    # MLP; residual 2 (reference vit/vit.py:147)
    h = ops.layernorm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps=eps)
    h = ops.matmul(h, lp["fc1"]["kernel"], lp["fc1"]["bias"], "gelu")
    return ops.matmul(h, lp["fc2"]["kernel"], lp["fc2"]["bias"]) + x


def forward(params: Params, pixels: jax.Array, cfg: ViTConfig) -> jax.Array:
    """Full ViT forward (reference vit/vit.py:240-247): embed ->
    ``lax.scan(encoder_block)`` -> final LN -> pooling/head.

    Returns, per ``cfg``:
    - hidden states (B, seq_len, D)      — ``pooling="none"``, no classes
      (the reference's only mode);
    - pooled embedding (B, D)            — ``pooling="cls" | "mean"``;
    - logits (B, num_classes)            — ``num_classes > 0``.
    """
    x = embed(params, pixels, cfg)

    def body(x, lp):
        return encoder_block(x, lp, cfg), None

    x, _ = jax.lax.scan(body, x, params["encoder"])
    x = ops.layernorm(x, params["ln_final"]["scale"],
                      params["ln_final"]["bias"], eps=cfg.layernorm_eps)
    return _forward_tail(x, params, cfg)


def _forward_tail(x: jax.Array, params: Params, cfg: ViTConfig) -> jax.Array:
    """Post-final-LN tail: pool/classify per ``cfg`` (reference
    vit/vit.py:240-247 returns the hidden states; pooling/classes are
    BASELINE extensions)."""
    if cfg.num_classes:
        pooled = x[:, 0] if cfg.pooling in ("none", "cls") else jnp.mean(x, axis=1)
        c = params["classifier"]
        return ops.matmul(pooled[:, None, :], c["kernel"], c["bias"])[:, 0]
    if cfg.pooling == "cls":
        return x[:, 0]
    if cfg.pooling == "mean":
        return jnp.mean(x, axis=1)
    return x


def forward_with_intermediates(params: Params, pixels: jax.Array,
                               cfg: ViTConfig):
    """Forward pass that also returns every layer's hidden states.

    The per-layer capture underlying the parity harness — the functional
    equivalent of the reference's forward hooks on every named module
    (reference 02_verifying_layer_outputs.ipynb cell 6). Returns
    ``(final, hiddens)`` where ``hiddens`` is a list of length
    ``num_layers + 1``: the embedding output followed by each encoder
    block's output (pre-final-LN) — the same convention as HF
    ``ViTModel(..., output_hidden_states=True)``.
    """
    x = embed(params, pixels, cfg)

    def body(x, lp):
        y = encoder_block(x, lp, cfg)
        return y, y

    final, layer_outs = jax.lax.scan(body, x, params["encoder"])
    hiddens = [x] + [layer_outs[i] for i in range(cfg.num_layers)]
    final = ops.layernorm(final, params["ln_final"]["scale"],
                          params["ln_final"]["bias"], eps=cfg.layernorm_eps)
    return final, hiddens


def make_forward(cfg: ViTConfig, *, jit: bool = True):
    """Bind the config and (optionally) jit — one fixed-shape executable per
    batch size, the reference's planned "fix all tensor sizes + CUDA graphs"
    optimization (reference README.md:28-29) for free."""
    fn = functools.partial(forward, cfg=cfg)
    return jax.jit(fn) if jit else fn
