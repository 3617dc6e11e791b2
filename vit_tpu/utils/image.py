"""Image preprocessing for ViT inference, jit-able on the device.

The reference has no preprocessing — it benchmarks on random tensors — but
a serving stack needs the HF ``ViTImageProcessor`` semantics on-device:
resize to (size, size) with bilinear interpolation, scale 1/255, then
per-channel normalize. This implements exactly those defaults as pure jnp
(so it fuses into the same XLA program as the model) and is parity-tested
against ``transformers.ViTImageProcessor`` in tests/test_image.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: google/vit-* preprocessor defaults (image_mean/std = 0.5 per channel).
VIT_MEAN = (0.5, 0.5, 0.5)
VIT_STD = (0.5, 0.5, 0.5)


def preprocess(images: jax.Array, *, size: int = 224,
               mean=VIT_MEAN, std=VIT_STD,
               rescale: float = 1.0 / 255.0,
               dtype=jnp.float32) -> jax.Array:
    """uint8/float (B, H, W, C) or (B, C, H, W) images -> normalized NCHW.

    Matches HF ViTImageProcessor defaults: bilinear resize to (size, size)
    (antialiased, matching PIL's filter whose support scales with the
    downsampling factor), rescale by 1/255, normalize with per-channel
    mean/std. Returns (B, C, size, size).
    """
    x = jnp.asarray(images)
    assert x.ndim == 4, f"expected batched images, got {x.shape}"
    if x.shape[-1] in (1, 3, 4) and x.shape[1] not in (1, 3, 4):
        x = x.transpose(0, 3, 1, 2)  # NHWC -> NCHW
    x = x.astype(jnp.float32) * rescale
    b, c, h, w = x.shape
    if (h, w) != (size, size):
        x = jax.image.resize(x, (b, c, size, size), method="bilinear",
                             antialias=True)
    mean = jnp.asarray(mean, jnp.float32).reshape(1, -1, 1, 1)
    std = jnp.asarray(std, jnp.float32).reshape(1, -1, 1, 1)
    return ((x - mean) / std).astype(dtype)
