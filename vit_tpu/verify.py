"""Per-layer HF parity verification CLI.

The reference verifies its model with a notebook that registers forward
hooks on every named module of both implementations and prints per-layer
max-abs-diffs (reference 02_verifying_layer_outputs.ipynb cells 6-10), plus
an all-ones structural-debug mode (cells 15-18). This is that workflow as a
first-class command:

    python -m vit_tpu.verify [--checkpoint PATH_OR_HF_ID] [--batch 2]
                             [--ones] [--hidden ... --patch ...]

Without ``--checkpoint`` (or when offline) the oracle is a randomly
initialized ``transformers.ViTModel`` built from config — the weight-mapping
path is identical either way. Exit code 0 iff end-to-end max-abs-diff is
below the BASELINE.json bar (1e-3).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def run_verification(hf_model, *, batch: int = 2, seed: int = 0,
                     tol: float = 1e-3) -> bool:
    import jax.numpy as jnp
    import torch

    from vit_tpu.models import vit
    from vit_tpu.weights import config_from_hf, params_from_hf

    cfg = config_from_hf(hf_model.config)
    params = params_from_hf(hf_model, cfg)
    rng = np.random.default_rng(seed)
    px = rng.standard_normal(
        (batch, 3, cfg.image_size, cfg.image_size)).astype(np.float32)

    with torch.no_grad():
        hf_out = hf_model(torch.from_numpy(px), output_hidden_states=True)
    import functools
    import jax
    fwd = jax.jit(functools.partial(vit.forward_with_intermediates, cfg=cfg))
    ours, hiddens = fwd(params, jnp.asarray(px))

    print(f"{'layer':<28} {'shape':<20} {'max|diff|':>12}")
    worst = 0.0
    names = ["embeddings"] + [f"encoder.layer.{i}"
                              for i in range(cfg.num_layers)]
    for name, theirs, mine in zip(names, hf_out.hidden_states, hiddens):
        diff = float(np.abs(theirs.numpy() - np.asarray(mine)).max())
        worst = max(worst, diff)
        print(f"{name:<28} {str(tuple(mine.shape)):<20} {diff:>12.3e}")

    final = float(np.abs(hf_out.last_hidden_state.numpy()
                         - np.asarray(ours)).max())
    print(f"{'final (post-LN)':<28} {str(tuple(ours.shape)):<20} "
          f"{final:>12.3e}")
    ok = final < tol
    print(f"\nend-to-end max-abs-diff {final:.3e} "
          f"{'<' if ok else '>='} {tol:g} -> {'PASSED' if ok else 'FAILED'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None,
                    help="HF model id or local path (omit for random init)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=None,
                    help="default 1e-3; 1e-2 with --ones (constant weights "
                         "make rows near-identical, so the final LN divides "
                         "by a tiny std and amplifies benign fp noise — the "
                         "reference notebook used atol=1.0 there, cell 10)")
    ap.add_argument("--ones", action="store_true",
                    help="constant-weight structural-debug mode "
                         "(reference notebook 02 cells 15-18)")
    # Random-init oracle geometry (defaults = ViT-B/16).
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--intermediate", type=int, default=3072)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--patch", type=int, default=16)
    ap.add_argument("--family", default="vit", choices=["vit", "deit"],
                    help="oracle model family (deit = CLS + distillation "
                         "token, 198 tokens)")
    args = ap.parse_args(argv)

    import torch
    import transformers

    deit = args.family == "deit"
    model_cls = transformers.DeiTModel if deit else transformers.ViTModel
    cfg_cls = transformers.DeiTConfig if deit else transformers.ViTConfig
    if args.checkpoint:
        hf = model_cls.from_pretrained(
            args.checkpoint, add_pooling_layer=False,
            attn_implementation="eager")
    else:
        hf_cfg = cfg_cls(
            hidden_size=args.hidden, num_hidden_layers=args.layers,
            num_attention_heads=args.heads,
            intermediate_size=args.intermediate,
            image_size=args.image, patch_size=args.patch,
            attn_implementation="eager")
        torch.manual_seed(args.seed)
        hf = model_cls(hf_cfg, add_pooling_layer=False)
        if deit:
            # HF random-init zeroes DeiT's learned tokens; a pretrained
            # checkpoint has real values — see tests/test_deit.py.
            with torch.no_grad():
                torch.nn.init.normal_(hf.embeddings.cls_token, std=0.02)
                torch.nn.init.normal_(hf.embeddings.distillation_token,
                                      std=0.02)
                torch.nn.init.normal_(hf.embeddings.position_embeddings,
                                      std=0.02)
        print("note: no checkpoint given — using random-init HF oracle "
              "(identical mapping path)")
    hf.eval()

    if args.tol is None:
        args.tol = 1e-2 if args.ones else 1e-3

    if args.ones:
        sd = hf.state_dict()
        for k, v in sd.items():
            sd[k] = torch.full_like(v, 0.01)
        hf.load_state_dict(sd)

    ok = run_verification(hf, batch=args.batch, seed=args.seed,
                          tol=args.tol)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
