"""Task-level int8 accuracy report: top-1 agreement vs the float model.

The int8 tier's speed (docs/QUANT.md) needs the accuracy half of the
tradeoff measured at task level, not just hidden-state error. This
tool builds the synthetic-golden ViT-B/16 (realistically scaled HF-layout
weights, vit_tpu/weights/synthetic.py) with a seeded classifier head and
compares, against the float forward:

- ``w8``          — weight-only quantization error: int8 weights
                    dequantized back to float, float activations (the
                    error floor of any weight-only int8 scheme)
- ``w8a8``        — the full int8 tier (vit_tpu.quant.forward_quant:
                    dynamic per-row activation quant, s8xs8->s32 dots)
- ``w8a8+smooth`` — SmoothQuant-folded (vit_tpu.quant.smooth_params)
                    before quantization

twice: on the plain synthetic checkpoint, and on an **outlier-channel
stress case** — a handful of LN gains scaled up so a few activation
channels dominate every row's amax, the exact pathology SmoothQuant
exists for (per-row dynamic scales lose all resolution on the other
channels; migrating the outlier into the weights restores it).

Metrics: top-1 agreement with the float model, mean |Δ| of the top-1
logit, max |Δ| over all logits, and hidden-state relative error.

Usage:  python tools/quant_accuracy.py [--batch 8] [--outlier-gain 32]
Runs on any backend in fp32; ~5 min at the defaults on one CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def build_params(cfg, seed=0):
    from vit_tpu.weights.hf import params_from_state_dict
    from vit_tpu.weights.synthetic import synthetic_hf_state_dict

    import dataclasses
    headless = dataclasses.replace(cfg, num_classes=0)
    sd = synthetic_hf_state_dict(headless)
    params = params_from_state_dict(sd, headless)
    rng = np.random.default_rng(seed + 7)
    d, n = cfg.hidden_dim, cfg.num_classes
    params["classifier"] = {
        "kernel": jnp.asarray(rng.standard_normal((d, n)) * d ** -0.5,
                              jnp.float32),
        "bias": jnp.zeros((n,), jnp.float32),
    }
    return params


def inject_outliers(params, cfg, *, gain, n_channels, seed=0):
    """Scale a few LN gains so those channels dominate activation rows —
    the LLM.int8/SmoothQuant outlier pathology, synthesized structurally.
    (The float model changes too; each tier is judged against ITS float
    oracle, so the comparison stays apples-to-apples.)"""
    rng = np.random.default_rng(seed + 13)
    idx = rng.choice(cfg.hidden_dim, size=n_channels, replace=False)
    enc = {k: dict(v) for k, v in params["encoder"].items()}
    for ln in ("ln1", "ln2"):
        s = np.asarray(enc[ln]["scale"], np.float32).copy()
        s[:, idx] *= gain
        enc[ln] = dict(enc[ln], scale=jnp.asarray(s))
    return dict(params, encoder=enc)


def dequantize(qparams):
    """Quantized pytree -> float pytree with the int8 rounding baked in
    (the weight-only tier's exact numerics)."""
    out = dict(qparams)
    enc = dict(qparams["encoder"])
    for name in ("qkv", "out", "fc1", "fc2"):
        p = dict(enc[name])
        k = p["kernel"]
        p["kernel"] = (k["q"].astype(jnp.float32)
                       * k["scale"][..., None, :].astype(jnp.float32))
        enc[name] = p
    out["encoder"] = enc
    return out


def compare(name, logits, hidden, ref_logits, ref_hidden):
    top1 = np.argmax(logits, -1)
    rtop1 = np.argmax(ref_logits, -1)
    agree = float(np.mean(top1 == rtop1))
    dl = np.abs(logits - ref_logits)
    top1_dl = float(np.mean(dl[np.arange(len(rtop1)), rtop1]))
    rel = float(np.linalg.norm(hidden - ref_hidden)
                / np.linalg.norm(ref_hidden))
    row = {"tier": name, "top1_agreement": round(agree, 4),
           "top1_logit_meanabsdiff": round(top1_dl, 4),
           "logit_maxabsdiff": round(float(dl.max()), 4),
           "hidden_rel_err": round(rel, 5)}
    print(f"  {name:<12} top-1 agree {agree * 100:6.2f}%   "
          f"top1 |dlogit| {top1_dl:.4f}   max |dlogit| {dl.max():.4f}   "
          f"hidden rel err {rel:.5f}", flush=True)
    return row


def run_case(case, params, cfg, px, alpha):
    from vit_tpu.models.vit import forward
    from vit_tpu.quant import forward_quant, quantize_params, smooth_params

    import dataclasses
    hcfg = dataclasses.replace(cfg, num_classes=0)
    hparams = {k: v for k, v in params.items() if k != "classifier"}

    def logits_and_hidden(fwd, p):
        ph = {k: v for k, v in p.items() if k != "classifier"}
        hidden = np.asarray(fwd(ph, px, hcfg))
        pooled = hidden[:, 0]
        c = p.get("classifier", params["classifier"])
        logits = pooled @ np.asarray(c["kernel"]) + np.asarray(c["bias"])
        return logits, hidden

    print(f"case: {case}", flush=True)
    ref_l, ref_h = logits_and_hidden(
        forward, params)
    rows = []
    q = quantize_params(params)
    rows.append(compare("w8", *logits_and_hidden(
        forward, dequantize(q)),
        ref_l, ref_h))
    rows.append(compare("w8a8", *logits_and_hidden(
        forward_quant, q),
        ref_l, ref_h))
    sm = smooth_params(hparams, hcfg, px, alpha=alpha)
    qs = quantize_params(dict(sm, classifier=params["classifier"]))
    rows.append(compare("w8a8+smooth", *logits_and_hidden(
        forward_quant, qs),
        ref_l, ref_h))
    for r in rows:
        r["case"] = case
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--outlier-gain", type=float, default=32.0)
    ap.add_argument("--outlier-channels", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="write rows to this path")
    ap.add_argument("--tiny", action="store_true",
                    help="small geometry smoke mode")
    args = ap.parse_args(argv)

    from vit_tpu.config import ViTConfig
    if args.tiny:
        cfg = ViTConfig(image_size=32, patch_size=16, hidden_dim=64,
                        num_heads=4, num_layers=2, mlp_dim=128,
                        num_classes=args.classes)
    else:
        cfg = ViTConfig(num_classes=args.classes)

    params = build_params(cfg, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    px = jnp.asarray(rng.standard_normal(
        (args.batch, cfg.num_channels, cfg.image_size, cfg.image_size)),
        jnp.float32)

    rows = run_case("plain", params, cfg, px, args.alpha)
    stressed = inject_outliers(params, cfg, gain=args.outlier_gain,
                               n_channels=args.outlier_channels,
                               seed=args.seed)
    rows += run_case(f"outlier x{args.outlier_gain:g}", stressed, cfg, px,
                     args.alpha)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
