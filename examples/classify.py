"""End-to-end image classification with vit_tpu.

The reference stops at hidden states (its model has no pooler or head,
reference vit/vit.py:203-247); this example shows the full user path the
framework adds on top: pretrained weights -> on-device preprocessing ->
one jit-compiled forward -> class label.

Works from either weight source (both offline-safe once cached):

    # a local HF checkpoint directory or model.safetensors file
    python examples/classify.py --weights /path/to/model.safetensors image.jpg

    # or a live transformers model (downloads once)
    python examples/classify.py --hf google/vit-base-patch16-224 image.jpg

With no image argument it classifies a synthetic test pattern so the
pipeline is runnable anywhere. Accepts .jpg/.png (needs PIL) or .npy
(H, W, 3) uint8 arrays.
"""

from __future__ import annotations

import argparse
import json
import os

import sys

import jax
import jax.numpy as jnp
import numpy as np

# Runnable as a plain script from anywhere: put the repo root (this file's
# parent's parent) on the path when vit_tpu isn't installed.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_image(path: str | None, size: int) -> np.ndarray:
    """-> (1, H, W, 3) uint8. Synthetic gradient pattern if path is None."""
    if path is None:
        y, x = np.mgrid[0:size, 0:size]
        img = np.stack([x * 255 // size, y * 255 // size,
                        (x + y) * 255 // (2 * size)], axis=-1)
        return img.astype(np.uint8)[None]
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from PIL import Image  # only needed for encoded images

        img = np.asarray(Image.open(path).convert("RGB"))
    assert img.ndim == 3 and img.shape[-1] == 3, img.shape
    return img.astype(np.uint8)[None]


def load_model(args):
    """-> (params, cfg, id2label) from --weights, --random-init, or --hf."""
    if args.random_init:  # offline smoke mode: pipeline only, random head
        from vit_tpu.config import ViTConfig
        from vit_tpu.models.vit import init_params

        cfg = ViTConfig(num_classes=args.num_classes)
        return init_params(jax.random.key(0), cfg), cfg, {}
    if args.weights:
        from vit_tpu.config import ViTConfig
        from vit_tpu.weights.checkpoint import (load_params,
                                                params_from_safetensors)

        path = args.weights
        if os.path.isdir(path):
            path = os.path.join(path, "model.safetensors")
        sidecar = path.removesuffix(".safetensors") + ".config.json"
        if os.path.exists(sidecar):  # a vit-tpu checkpoint (save_params)
            params, cfg = load_params(path)
        else:  # a raw HF model.safetensors export
            cfg = ViTConfig(num_classes=args.num_classes,
                            dtype=jnp.bfloat16)
            params = params_from_safetensors(path, cfg)
        labels = {}
        cfg_json = os.path.join(os.path.dirname(path), "config.json")
        if os.path.exists(cfg_json):  # HF checkpoints ship labels here
            with open(cfg_json) as f:
                labels = json.load(f).get("id2label", {})
        return params, cfg, labels

    from transformers import AutoConfig, AutoModelForImageClassification

    from vit_tpu.weights import config_from_hf, params_from_hf

    # AutoModel picks the right class per checkpoint (ViT, DeiT, DeiT
    # WithTeacher); the import path maps each (vit_tpu/weights/hf.py).
    if AutoConfig.from_pretrained(args.hf).model_type not in ("vit", "deit"):
        raise SystemExit(f"unsupported model family for {args.hf}")
    hf = AutoModelForImageClassification.from_pretrained(args.hf)
    cfg = config_from_hf(hf.config, num_classes=hf.config.num_labels,
                         dtype=jnp.bfloat16)
    return params_from_hf(hf, cfg), cfg, {
        str(i): n for i, n in getattr(hf.config, "id2label", {}).items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image", nargs="?", default=None,
                    help=".jpg/.png/.npy image (default: synthetic pattern)")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--weights", help="model.safetensors / checkpoint dir")
    src.add_argument("--hf", default="google/vit-base-patch16-224",
                     help="HF model id (classification head variant)")
    src.add_argument("--random-init", action="store_true",
                     help="random weights (offline pipeline smoke test)")
    ap.add_argument("--num-classes", type=int, default=1000,
                    help="head size when loading raw safetensors")
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args()

    params, cfg, id2label = load_model(args)
    img = load_image(args.image, cfg.image_size)

    from vit_tpu.models.vit import forward
    from vit_tpu.utils.image import preprocess

    @jax.jit
    def classify(params, img):
        x = preprocess(img, size=cfg.image_size, dtype=cfg.dtype)
        logits = forward(params, x, cfg)
        return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)

    probs = np.asarray(jax.block_until_ready(classify(params, img)))[0]
    if not cfg.num_classes:
        raise SystemExit("loaded weights have no classification head; "
                         "use a *ForImageClassification checkpoint")
    for i in np.argsort(probs)[::-1][:args.top]:
        name = id2label.get(str(int(i)), f"class {int(i)}")
        print(f"{probs[i]:6.3f}  {name}")


if __name__ == "__main__":
    main()
