"""DeiT family (CLS + distillation token) — model-family extension.

The reference supports only google/vit-* (SURVEY.md §2.2); DeiT is the
same encoder with a second learned prefix token (198 tokens for B/16).
Oracle: ``transformers.DeiTModel`` random-init from config, through the
identical state-dict import path a pretrained checkpoint would take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import transformers

from vit_tpu.config import VARIANTS, ViTConfig
from vit_tpu.models import vit
from vit_tpu.weights import config_from_hf, params_from_hf


def _make_deit(hidden=48, layers=2, heads=4, inter=96, image=32, patch=16,
               seed=0):
    hf_cfg = transformers.DeiTConfig(
        hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=inter,
        image_size=image, patch_size=patch, attn_implementation="eager")
    torch.manual_seed(seed)
    model = transformers.DeiTModel(hf_cfg, add_pooling_layer=False)
    # HF random-init zeroes the prefix tokens (a pretrained checkpoint has
    # learned values); make them non-zero so the import zero-scan sees the
    # realistic case.
    with torch.no_grad():
        torch.nn.init.normal_(model.embeddings.cls_token, std=0.02)
        torch.nn.init.normal_(model.embeddings.distillation_token, std=0.02)
        torch.nn.init.normal_(model.embeddings.position_embeddings, std=0.02)
    model.eval()
    return model


def test_deit_config_mapping():
    hf = _make_deit()
    cfg = config_from_hf(hf.config)
    assert cfg.num_prefix_tokens == 2
    assert cfg.seq_len == (32 // 16) ** 2 + 2  # patches + CLS + distillation
    assert VARIANTS["DeiT-B/16"].seq_len == 198


def test_deit_end_to_end_parity():
    hf = _make_deit()
    cfg = config_from_hf(hf.config)
    params = params_from_hf(hf, cfg)
    assert params["embeddings"]["cls_token"].shape == (1, 2, 48)

    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(px)).last_hidden_state.numpy()
    got = np.asarray(vit.forward(params, jnp.asarray(px), cfg))
    diff = np.abs(want - got).max()
    assert diff < 1e-4, f"max-abs-diff {diff}"


def test_deit_forward_matches_oracle(rng):
    # Two prefix tokens through the whole forward vs the float64 oracle.
    import np_oracle

    cfg = ViTConfig(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
                    num_layers=2, mlp_dim=128, num_prefix_tokens=2)
    params = vit.init_params(jax.random.key(0), cfg)
    px = jnp.asarray(rng.standard_normal((2, 3, 32, 32)), jnp.float32)
    a = np.asarray(vit.forward(params, px, cfg), np.float64)
    assert a.shape == (2, 6, 64)  # 4 patches + 2 prefix tokens
    np.testing.assert_allclose(a, np_oracle.forward(params, px, cfg),
                               rtol=0, atol=2e-5)


def test_deit_classifier_import_both_variants(rng):
    # Plain DeiTForImageClassification maps `classifier.*`; the WithTeacher
    # variant maps `cls_classifier.*` -> classifier and skips the
    # distillation head.
    for cls in (transformers.DeiTForImageClassification,
                transformers.DeiTForImageClassificationWithTeacher):
        hf_cfg = transformers.DeiTConfig(
            hidden_size=48, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=96, image_size=32, patch_size=16,
            num_labels=10, attn_implementation="eager")
        torch.manual_seed(1)
        hf = cls(hf_cfg)
        with torch.no_grad():
            emb = (hf.deit if hasattr(hf, "deit") else hf).embeddings
            torch.nn.init.normal_(emb.cls_token, std=0.02)
            torch.nn.init.normal_(emb.distillation_token, std=0.02)
            torch.nn.init.normal_(emb.position_embeddings, std=0.02)
        hf.eval()
        cfg = config_from_hf(hf_cfg, num_classes=10)
        from vit_tpu.weights import params_from_state_dict
        params = params_from_state_dict(hf.state_dict(), cfg)
        assert params["classifier"]["kernel"].shape == (48, 10)

        px = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
        got = np.asarray(vit.forward(params, jnp.asarray(px), cfg))
        with torch.no_grad():
            out = hf(torch.from_numpy(px)).logits.numpy()
        if cls is transformers.DeiTForImageClassification:
            # exact parity: HF applies the same CLS head
            assert np.abs(got - out).max() < 1e-4
        else:
            # WithTeacher averages CLS and distillation logits; ours is the
            # CLS head alone — shapes agree, values differ by construction.
            assert got.shape == out.shape
