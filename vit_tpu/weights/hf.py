"""HuggingFace ViT -> vit_tpu params import.

The JAX-native rework of the reference's weight-transfer path
(reference vit/utils.py:45-113 ``transfer_pretrained_weights``,
reference vit/load_weights.py:11-62 ``map_attn_layers``/``map_non_attn_layers``).

Design decisions, made explicitly (SURVEY.md §7 checklist 3):

- **Weight convention is (in, out)** so every linear is a plain ``x @ W``
  GEMM with no transposes in the hot path (the reference made the same call —
  its ``LinearWithBias`` stores (in, out), reference vit/vit.py:25-35 — and
  paid one-time ``.t()`` at load, reference load_weights.py:51-53).
- **QKV stays fused — wider, not split.** The reference splits HF's
  (768, 768) q/k/v into 12 per-head (768, 64) matrices purely because its
  model has per-head modules (reference load_weights.py:28-31, head dim 64
  hardcoded). Here the three projections are concatenated into one
  (D, 3D) matmul; heads are carved out by reshape inside the attention op.
- **Layer stacking**: per-layer tensors are stacked along a leading
  ``num_layers`` axis to feed ``lax.scan``.
- **Verification**: name-coverage check (every source tensor consumed or
  knowingly skipped — the reference silently drops ``pooler.*``,
  reference vit/utils.py:63-64) plus the reference's post-load all-zero scan
  (reference vit/utils.py:104-111).
"""

from __future__ import annotations

from typing import Any, Mapping

import jax.numpy as jnp
import numpy as np

from vit_tpu.config import ViTConfig
from vit_tpu.models.vit import Params

#: Source tensors we intentionally do not import (the reference's model has
#: no pooler either; its mapping listed pooler keys but they were silently
#: skipped — reference vit/utils.py:63-64, SURVEY.md §2.3). DeiT's
#: distillation head exists only for training-time distillation; HF's own
#: DeiTForImageClassification ignores it at inference.
SKIPPED_PREFIXES = ("pooler.", "distillation_classifier.")


def _to_np(t: Any) -> np.ndarray:
    """Accept torch tensors, numpy arrays, or jax arrays."""
    if hasattr(t, "detach"):  # torch.Tensor without importing torch
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _normalize_state_dict(sd: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Strip an optional ``vit.`` prefix (ViTForImageClassification) and
    convert all tensors to numpy."""
    out = {}
    for k, v in sd.items():
        for prefix in ("vit.", "deit."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.startswith("cls_classifier."):
            # DeiTForImageClassificationWithTeacher: import the CLS head as
            # the classifier. (HF's WithTeacher inference averages CLS and
            # distillation-head logits; the CLS head alone is the standard
            # deployment head and the distillation head is skipped —
            # SKIPPED_PREFIXES.) The plain DeiTForImageClassification
            # already names its head `classifier.`.
            k = "classifier." + k[len("cls_classifier."):]
        out[k] = _to_np(v)
    return out


def config_from_hf(hf_config: Any, **overrides) -> ViTConfig:
    """Build a :class:`ViTConfig` from a ``transformers`` ViT/DeiT config."""
    # DeiT adds a learned distillation token after CLS (model_type 'deit').
    overrides.setdefault(
        "num_prefix_tokens",
        2 if getattr(hf_config, "model_type", "") == "deit" else 1)
    return ViTConfig(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        num_channels=hf_config.num_channels,
        hidden_dim=hf_config.hidden_size,
        num_heads=hf_config.num_attention_heads,
        num_layers=hf_config.num_hidden_layers,
        mlp_dim=hf_config.intermediate_size,
        layernorm_eps=hf_config.layer_norm_eps,
        **overrides,
    )


def params_from_state_dict(sd: Mapping[str, Any], cfg: ViTConfig) -> Params:
    """Map an HF ``ViTModel`` (or ``ViTForImageClassification``) state dict to
    the vit_tpu params pytree, with full coverage accounting.

    Raises ``KeyError`` listing any unconsumed source tensors (other than the
    knowingly-skipped pooler) or any missing destination.
    """
    sd = _normalize_state_dict(sd)
    consumed: set[str] = set()
    dt = cfg.dtype

    def take(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(f"HF state dict missing expected tensor {name!r}")
        consumed.add(name)
        return sd[name]

    def linear(prefix: str) -> dict[str, jnp.ndarray]:
        # HF nn.Linear stores (out, in); we store (in, out) — see module doc.
        w = take(f"{prefix}.weight")
        b = take(f"{prefix}.bias")
        return {"kernel": jnp.asarray(w.T, dt), "bias": jnp.asarray(b, dt)}

    def ln(prefix: str) -> dict[str, np.ndarray]:
        return {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    d = cfg.hidden_dim

    # --- embeddings (reference vit/vit.py:173-200 params) ------------------
    conv_w = take("embeddings.patch_embeddings.projection.weight")
    assert conv_w.shape == (d, cfg.num_channels, cfg.patch_size, cfg.patch_size), (
        conv_w.shape, cfg)
    # (D, C, P, P) -> flatten filter in (channel, kh, kw) order -> (C*P*P, D),
    # matching ops.patchify's per-patch element order.
    patch_kernel = conv_w.reshape(d, cfg.patch_dim).T

    # DeiT stores its second prefix token separately; our pytree packs all
    # prefix tokens into one (1, num_prefix_tokens, D) leaf.
    cls = take("embeddings.cls_token")
    if "embeddings.distillation_token" in sd:
        cls = np.concatenate([cls, take("embeddings.distillation_token")],
                             axis=1)
    assert cls.shape[1] == cfg.num_prefix_tokens, (cls.shape, cfg)
    embeddings = {
        "cls_token": jnp.asarray(cls, dt),
        "position_embeddings": jnp.asarray(
            take("embeddings.position_embeddings"), dt),
        "patch_embed": {
            "kernel": jnp.asarray(patch_kernel, dt),
            "bias": jnp.asarray(
                take("embeddings.patch_embeddings.projection.bias"), dt),
        },
    }

    # --- encoder: per-layer -> stacked (reference load_weights.py mapping) --
    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        # Fuse q/k/v into one (D, 3D) projection (see module docstring).
        qw = take(f"{p}.attention.attention.query.weight").T
        kw = take(f"{p}.attention.attention.key.weight").T
        vw = take(f"{p}.attention.attention.value.weight").T
        qb = take(f"{p}.attention.attention.query.bias")
        kb = take(f"{p}.attention.attention.key.bias")
        vb = take(f"{p}.attention.attention.value.bias")
        layers.append({
            "ln1": ln(f"{p}.layernorm_before"),
            "qkv": {"kernel": np.concatenate([qw, kw, vw], axis=1),
                    "bias": np.concatenate([qb, kb, vb])},
            "out": linear(f"{p}.attention.output.dense"),
            "ln2": ln(f"{p}.layernorm_after"),
            "fc1": linear(f"{p}.intermediate.dense"),
            "fc2": linear(f"{p}.output.dense"),
        })

    import jax
    encoder = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x, dt) for x in xs]),
                           *layers)

    params: Params = {
        "embeddings": embeddings,
        "encoder": encoder,
        "ln_final": {k: jnp.asarray(v, dt)
                     for k, v in ln("layernorm").items()},
    }

    if cfg.num_classes:
        params["classifier"] = linear("classifier")

    # --- coverage check (reference only scanned for zeros; we also require
    # every source tensor to be consumed or knowingly skipped) ---------------
    leftover = [k for k in sd
                if k not in consumed and not k.startswith(SKIPPED_PREFIXES)
                and k != "classifier.weight" and k != "classifier.bias"]
    if leftover:
        raise KeyError(f"unconsumed HF tensors (mapping incomplete): {leftover}")

    verify_params(params)
    return params


def params_from_hf(hf_model: Any, cfg: ViTConfig | None = None) -> Params:
    """Import from a live ``transformers`` model object (ViTModel or
    ViTForImageClassification)."""
    if cfg is None:
        hf_cfg = hf_model.config
        num_classes = getattr(hf_cfg, "num_labels", 0)
        if not hasattr(hf_model, "classifier"):
            num_classes = 0
        cfg = config_from_hf(hf_cfg, num_classes=num_classes)
    return params_from_state_dict(hf_model.state_dict(), cfg)


def verify_params(params: Params) -> None:
    """The reference's post-load sanity scan: no tensor may be all zeros
    except biases/LN offsets which are legitimately zero-initialized in fresh
    models (reference vit/utils.py:104-111 scans for uninitialized tensors).

    Encoder leaves are stacked (layer, ...) — each layer's slice is scanned
    individually so a single uninitialized layer can't hide behind the rest.
    """
    import jax

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        if "bias" in name:
            continue
        arr = np.asarray(jax.device_get(leaf))
        if name.startswith("['encoder']"):
            for i in range(arr.shape[0]):
                if not np.any(arr[i]):
                    raise ValueError(f"imported tensor {name} layer {i} is "
                                     "all zeros (weight transfer incomplete?)")
        elif not np.any(arr):
            raise ValueError(f"imported tensor {name} is all zeros "
                             "(weight transfer incomplete?)")
