"""End-to-end training with vit_tpu: overfit a tiny ViT on synthetic data.

The reference is inference-only and scopes training out on its roadmap
(reference README.md:31-33); this example demonstrates the training tier the
framework adds — ``vit_tpu.train.make_train_step`` — actually *learning*:
a tiny ViT classifier is trained from random init on a 4-class synthetic
pattern dataset until it fits the training set.

    python examples/train_tiny.py                  # any backend

Every step is one jit-compiled program: forward, softmax cross-entropy,
backward (XLA autodiff), AdamW update — see vit_tpu/train.py. Prints loss every ``--log-every`` steps and final
train accuracy.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def make_dataset(n: int, size: int, num_classes: int,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic (pixels, labels): class k brightens quadrant k, plus noise.

    Linearly separable enough to overfit fast, noisy enough that the model
    must actually use the patch content (a constant predictor gets 1/k).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, (n,)).astype(np.int32)
    pixels = rng.normal(0.0, 0.3, (n, 3, size, size)).astype(np.float32)
    h = size // 2
    quads = [(slice(0, h), slice(0, h)), (slice(0, h), slice(h, None)),
             (slice(h, None), slice(0, h)), (slice(h, None), slice(h, None))]
    for i, k in enumerate(labels):
        ys, xs = quads[int(k) % 4]
        pixels[i, :, ys, xs] += 1.0 + (int(k) // 4) * 0.5
    return pixels, labels


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--n", type=int, default=64, help="dataset size")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="resume from PATH if present; save there at the end")
    args = p.parse_args(argv)

    from vit_tpu.config import ViTConfig
    from vit_tpu.models.vit import forward, init_params
    from vit_tpu.train import make_optimizer, make_train_step

    cfg = ViTConfig(image_size=32, patch_size=8, hidden_dim=64, num_heads=4,
                    num_layers=2, mlp_dim=128, num_classes=4)
    params = init_params(jax.random.key(args.seed), cfg)
    pixels, labels = make_dataset(args.n, cfg.image_size, cfg.num_classes,
                                  seed=args.seed)

    init_fn, step_fn = make_train_step(
        cfg, make_optimizer(learning_rate=args.lr, weight_decay=0.0))
    opt_state = init_fn(params)

    start = 0
    if args.checkpoint and os.path.exists(args.checkpoint + ".orbax"):
        from vit_tpu.weights.checkpoint import restore_train_state

        params, opt_state, start = restore_train_state(
            args.checkpoint, (params, opt_state))
        print(f"resumed from {args.checkpoint} at step {start}", flush=True)

    rng = np.random.default_rng(args.seed + start)
    first_loss = None
    for step in range(start + 1, start + args.steps + 1):
        idx = rng.choice(args.n, size=args.batch, replace=False)
        params, opt_state, loss = step_fn(
            params, opt_state, jnp.asarray(pixels[idx]),
            jnp.asarray(labels[idx]))
        loss = float(loss)
        if first_loss is None:
            first_loss = loss
        if step % args.log_every == 0 or step == 1:
            print(f"step {step:4d}  loss {loss:.4f}", flush=True)

    if args.checkpoint:
        from vit_tpu.weights.checkpoint import save_train_state

        save_train_state(args.checkpoint, params, opt_state,
                         start + args.steps)
        print(f"saved {args.checkpoint} at step {start + args.steps}",
              flush=True)

    logits = jax.jit(lambda p, x: forward(p, x, cfg))(
        params, jnp.asarray(pixels))
    acc = float(np.mean(np.argmax(np.asarray(logits), -1) == labels))
    print(f"final loss {loss:.4f} (from {first_loss:.4f})  "
          f"train accuracy {acc:.2%}")
    return acc


if __name__ == "__main__":
    main()
