"""An independent float64 NumPy oracle of every op and of the whole ViT.

Written from the reference's semantics (pre-LN blocks, biased variance with
eps inside the sqrt, exact erf-GELU, scaled-dot-product attention, CLS +
learned positions, final LN) without touching the code under test, so the
op library, the model and the smoke phases can all be checked against it.
Inputs may be JAX or NumPy arrays of any float dtype; everything is
computed in float64.
"""

from __future__ import annotations

import numpy as np
from scipy import special


def f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def layernorm(x, scale, bias, eps=1e-12):
    x = f64(x)
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * f64(scale) + f64(bias)


def gelu(x):
    x = f64(x)
    return 0.5 * x * (1.0 + special.erf(x / np.sqrt(2.0)))


def softmax(x):
    x = f64(x)
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def linear(x, w, bias=None, activation=None):
    out = f64(x) @ f64(w)
    if bias is not None:
        out = out + f64(bias)
    if activation == "gelu":
        out = gelu(out)
    return out


def attention_bhsd(q, k, v, scale=None, seq_len=None):
    """(B, H, S, d) attention; ``seq_len`` masks padding keys."""
    q, k, v = f64(q), f64(k), f64(v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if seq_len is not None:
        scores[..., seq_len:] = -np.inf
    return np.einsum("bhqk,bhkd->bhqd", softmax(scores), v)


def attention_bshd(q, k, v, scale=None):
    """(B, S, H, d) attention — the layout of ``vit_tpu.ops.attention``."""
    t = (0, 2, 1, 3)
    return attention_bhsd(f64(q).transpose(t), f64(k).transpose(t),
                          f64(v).transpose(t), scale).transpose(t)


def patchify(x, p):
    x = f64(x)
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p).transpose(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def embed(params, pixels, cfg):
    e = params["embeddings"]
    x = linear(patchify(pixels, cfg.patch_size), e["patch_embed"]["kernel"],
               e["patch_embed"]["bias"])
    cls = np.broadcast_to(f64(e["cls_token"]),
                          (x.shape[0], cfg.num_prefix_tokens, x.shape[2]))
    return np.concatenate([cls, x], axis=1) + f64(e["position_embeddings"])


def block(x, lp, cfg):
    """One pre-LN encoder block; ``lp`` is one layer's params."""
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    eps = cfg.layernorm_eps
    h = layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps)
    qkv = linear(h, lp["qkv"]["kernel"], lp["qkv"]["bias"])
    qkv = qkv.reshape(b, s, 3, nh, hd)
    ctx = attention_bshd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    x = x + linear(ctx.reshape(b, s, d), lp["out"]["kernel"],
                   lp["out"]["bias"])
    h = layernorm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps)
    h = linear(h, lp["fc1"]["kernel"], lp["fc1"]["bias"], "gelu")
    return x + linear(h, lp["fc2"]["kernel"], lp["fc2"]["bias"])


def layer(params, i):
    """Layer ``i``'s slice of the stacked encoder params."""
    return {k: {kk: np.asarray(vv)[i] for kk, vv in v.items()}
            for k, v in params["encoder"].items()}


def forward_with_hiddens(params, pixels, cfg):
    """(final post-LN hidden states, [embedding, block 1 .. block L])."""
    x = embed(params, pixels, cfg)
    hiddens = [x]
    for i in range(cfg.num_layers):
        x = block(x, layer(params, i), cfg)
        hiddens.append(x)
    final = layernorm(x, params["ln_final"]["scale"],
                      params["ln_final"]["bias"], cfg.layernorm_eps)
    return final, hiddens


def forward(params, pixels, cfg):
    """Hidden states, pooled embedding or logits, per ``cfg``."""
    x, _ = forward_with_hiddens(params, pixels, cfg)
    if cfg.num_classes:
        pooled = x[:, 0] if cfg.pooling in ("none", "cls") else x.mean(1)
        c = params["classifier"]
        return linear(pooled, c["kernel"], c["bias"])
    if cfg.pooling == "cls":
        return x[:, 0]
    if cfg.pooling == "mean":
        return x.mean(1)
    return x
