"""Public op library — the equivalent of reference vit/kernels/.

Export surface mirrors the ops the model runs (reference
vit/kernels/__init__.py:1-7: patching, matmul, softmax, layernorm, conv2d as
patch embed) plus the fused ``attention`` the reference only planned
(reference README.md:27 "Add Flash attn").

Every op is plain ``jnp``/``lax`` (:mod:`vit_tpu.ops.reference`): under
``jax.jit`` XLA fuses the elementwise work into the neighbouring library
GEMMs. The one op with more than one implementation is :func:`attention`,
whose route is chosen from what the code can observe — the platform and the
operand dtype — never from a flag (:func:`attention_route`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vit_tpu.ops import reference
from vit_tpu.ops.reference import (gelu, layernorm, matmul, patch_embed,
                                   patchify, softmax)

__all__ = [
    "layernorm", "softmax", "matmul", "patchify", "patch_embed", "gelu",
    "attention", "attention_route", "reference",
]

#: Operand dtypes cuDNN's fused attention takes (half-precision only).
_CUDNN_DTYPES = (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))


def attention_route(dtype, platform: str | None = None) -> str:
    """The attention implementation for ``dtype`` operands on ``platform``
    (default: JAX's default backend).

    - ``"cudnn"``: bf16/fp16 on a GPU — cuDNN's fused (flash) attention
      through XLA, which never writes the (S, S) scores to device memory
      (the fastest of three routes timed inside the bf16 forward on an
      H100, PERF.md);
    - ``"xla"``: everything else — the plain scores -> softmax -> context
      chain (:func:`vit_tpu.ops.reference.attention`), which keeps fp32 at
      ``Precision.HIGHEST`` and is the oracle for the fused route.
    """
    platform = platform or jax.default_backend()
    if platform == "gpu" and jnp.dtype(dtype) in _CUDNN_DTYPES:
        return "cudnn"
    return "xla"


def _plain_attention(q, k, v, scale):
    bhsd = (0, 2, 1, 3)
    out = reference.attention(q.transpose(bhsd), k.transpose(bhsd),
                              v.transpose(bhsd), scale=scale)
    return out.transpose(bhsd)


def _with_plain_backward(fused):
    """``fused(q, k, v, scale)`` as the forward, with the gradient of the
    plain chain, recomputed from q, k and v in the backward pass."""
    @functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
    def fn(q, k, v, scale):
        return fused(q, k, v, scale)

    def fwd(q, k, v, scale):
        return fused(q, k, v, scale), (q, k, v)

    def bwd(scale, res, g):
        _, vjp = jax.vjp(functools.partial(_plain_attention, scale=scale),
                         *res)
        return vjp(g)

    fn.defvjp(fwd, bwd)
    return fn


# cuDNN's fused backward refuses odd sequence lengths (ViT's 197, 257 and
# 577 tokens) when training, so the fused route keeps cuDNN's forward and
# takes its gradient from the plain chain.
_cudnn_attention = _with_plain_backward(
    lambda q, k, v, scale: jax.nn.dot_product_attention(
        q, k, v, scale=scale, implementation="cudnn"))


def attention(q: jax.Array, k: jax.Array, v: jax.Array, *,
              scale: float | None = None) -> jax.Array:
    """Multi-head scaled-dot-product attention in (B, S, H, d) layout — the
    layout the fused QKV projection produces, so no head transposes are
    needed before the fused route. Returns (B, S, H, d)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if attention_route(q.dtype) == "cudnn":
        return _cudnn_attention(q, k, v, scale)
    return _plain_attention(q, k, v, scale)
