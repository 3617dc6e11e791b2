"""Pure-jnp implementations of every op the model runs.

These are the model's main path — under ``jax.jit`` XLA fuses the
elementwise work into the neighbouring cuBLAS/cuDNN GEMMs — AND the test
oracle for any other route (the role ``torch`` plays for the reference's
per-kernel ``__main__`` allclose tests, e.g. reference
vit/kernels/matmul.py:159-192).

Semantics notes (kept bit-compatible with the reference / HF):

- ``layernorm``: biased variance, eps added *inside* the sqrt
  (reference vit/kernels/layernorm.py:72-73, matching ``F.layer_norm``).
- ``gelu``: exact erf form, not tanh approximation
  (reference vit/kernels/activations.py:8-20).
- ``matmul``: fp32 accumulation regardless of input dtype
  (reference vit/kernels/matmul.py:92 uses an fp32 ``tl.dot`` accumulator).
- ``softmax``: numerically-stable row softmax on the last axis
  (reference vit/kernels/softmax.py:9-74).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _precision(dtype):
    """fp32 inputs use HIGHEST — true fp32 products, no TF32 on the tensor
    cores — so results keep the reference's fp32 semantics (reference
    vit/kernels/matmul.py:92); low-precision inputs use the hardware-native
    default (bf16 products, fp32 accumulation)."""
    return (jax.lax.Precision.HIGHEST
            if jnp.dtype(dtype) == jnp.float32 else None)


def gelu(x: jax.Array) -> jax.Array:
    """Exact erf-form GELU: 0.5 * x * (1 + erf(x / sqrt(2))).

    Mirrors reference vit/kernels/activations.py:8-20. ``jax.nn.gelu`` with
    ``approximate=False`` is the same formula; we spell it out so every
    caller shares one definition.
    """
    return 0.5 * x * (1.0 + jax.lax.erf(x * (2.0 ** -0.5)))


def layernorm(
    x: jax.Array, scale: jax.Array, bias: jax.Array, *, eps: float = 1e-12
) -> jax.Array:
    """Row-wise layernorm over the last dim, biased variance, eps in sqrt.

    Mirrors reference vit/kernels/layernorm.py:28-142. Statistics are computed
    in fp32 for low-precision inputs; output is cast back to the input dtype.
    """
    orig_dtype = x.dtype
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    normed = (x32 - mean) / jnp.sqrt(var + eps)
    out = normed * scale.astype(jnp.float32) + bias.astype(jnp.float32)
    return out.astype(orig_dtype)


def softmax(x: jax.Array) -> jax.Array:
    """Numerically-stable softmax over the last axis.

    Mirrors reference vit/kernels/softmax.py:9-74 (row max subtracted, -inf
    padding semantics for masked tails).
    """
    orig_dtype = x.dtype
    x32 = x.astype(jnp.float32)
    x32 = x32 - jnp.max(x32, axis=-1, keepdims=True)
    e = jnp.exp(x32)
    out = e / jnp.sum(e, axis=-1, keepdims=True)
    return out.astype(orig_dtype)


def matmul(
    x: jax.Array,
    w: jax.Array,
    bias: jax.Array | None = None,
    activation: str | None = None,
) -> jax.Array:
    """Shared-weight batched matmul ``(B, M, K) @ (K, N)`` + fused bias + GELU.

    The workhorse behind every Linear layer. Mirrors reference
    vit/kernels/matmul.py:40-156 (fp32 accumulator at matmul.py:92; bias
    epilogue at :100-102; gelu epilogue at :104-106). Weight convention is
    (in, out) like the reference's ``LinearWithBias`` (reference vit/vit.py:25-35).
    """
    assert x.shape[-1] == w.shape[0], (x.shape, w.shape)
    out = jnp.matmul(x, w, preferred_element_type=jnp.float32,
                     precision=_precision(x.dtype))
    if bias is not None:
        out = out + bias.astype(jnp.float32)
    if activation == "gelu":
        out = gelu(out)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return out.astype(x.dtype)


def patchify(x: jax.Array, patch_size: int) -> jax.Array:
    """Rearrange an NCHW image batch into flattened patch rows.

    ``(B, C, H, W) -> (B, (H/P)*(W/P), C*P*P)`` with per-patch element order
    (channel, patch_row, patch_col) — the ordering the reference's patching
    kernel produces (reference vit/kernels/patching.py:37-51 interleaves the
    R/G/B channel blocks) and that ``torch.nn.Unfold`` uses
    (reference patching.py:95-105 ``patching_torch``).
    """
    b, c, h, w = x.shape
    p = patch_size
    assert h % p == 0 and w % p == 0, (x.shape, p)
    hp, wp = h // p, w // p
    x = x.reshape(b, c, hp, p, wp, p)
    x = x.transpose(0, 2, 4, 1, 3, 5)  # (B, Hp, Wp, C, P, P)
    return x.reshape(b, hp * wp, c * p * p)


def patch_embed(
    x: jax.Array, w: jax.Array, bias: jax.Array | None, patch_size: int
) -> jax.Array:
    """Patch-embedding "convolution" as unfold + matmul.

    Equivalent to the reference's non-overlapping conv2d patch embed
    (reference vit/kernels/conv2d.py:19-167, stride == kernel) followed by HF's
    ``flatten(2).transpose(1, 2)`` (reference vit/vit.py:192) — but expressed
    as ``patchify`` + one big GEMM, the layout the reference's own
    roadmap targets (reference README.md:26 "Faster Conv1D"; its scalar-loop
    conv2d was its slowest kernel, SURVEY.md §6).

    ``w`` is (C*P*P, D): the HF conv weight (D, C, P, P) flattened in
    (channel, kh, kw) order then transposed. Output: (B, num_patches, D).
    """
    patches = patchify(x, patch_size)
    return matmul(patches, w, bias)


def attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    scale: float | None = None,
) -> jax.Array:
    """Multi-head scaled-dot-product attention, (B, H, S, d) layout.

    The plain route of :func:`vit_tpu.ops.attention` and the oracle for its
    fused route. Equivalent to the reference's per-head matmul3 -> softmax
    -> matmul3 chain (reference vit/vit.py:66-72) but batched over heads.
    No attention mask / dropout (the reference has neither; dropout TODO at
    reference vit/vit.py:43).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                        preferred_element_type=jnp.float32,
                        precision=_precision(q.dtype)) * scale
    probs = softmax(scores)
    out = jnp.einsum("bhqk,bhkd->bhqd", probs.astype(q.dtype), v,
                     preferred_element_type=jnp.float32,
                     precision=_precision(q.dtype))
    return out.astype(q.dtype)
