"""Production-dtype (bf16) accuracy vs the fp32 HF oracle.

The reference only ever runs fp32 (reference vit/vit.py:23); on the GPU the
production inference dtype is bfloat16, so its deviation from the fp32
oracle is a first-class quantity. Bound it explicitly.
"""

import jax.numpy as jnp
import numpy as np
import torch
import transformers

from vit_tpu.models import vit
from vit_tpu.weights import config_from_hf, params_from_hf


def test_bf16_forward_close_to_fp32_oracle():
    hf_cfg = transformers.ViTConfig(
        hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
        intermediate_size=128, image_size=64, patch_size=16,
        attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.ViTModel(hf_cfg, add_pooling_layer=False).eval()

    cfg32 = config_from_hf(hf_cfg)
    cfg16 = config_from_hf(hf_cfg, dtype=jnp.bfloat16)
    p32 = params_from_hf(hf, cfg32)
    p16 = params_from_hf(hf, cfg16)

    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(px)).last_hidden_state.numpy()

    out32 = np.asarray(vit.forward(p32, jnp.asarray(px), cfg32))
    out16 = np.asarray(vit.forward(p16, jnp.asarray(px), cfg16),
                       dtype=np.float32)

    assert np.abs(out32 - want).max() < 1e-4            # fp32: tight
    # bf16 has ~3 decimal digits; activations here are O(1) post-LN.
    diff16 = np.abs(out16 - want).max()
    assert diff16 < 0.15, f"bf16 deviation {diff16}"
    # and bf16 must track fp32 closely in RMS terms
    rms = np.sqrt(np.mean((out16 - out32) ** 2))
    assert rms < 0.02, f"bf16 rms deviation {rms}"
