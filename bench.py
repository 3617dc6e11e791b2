"""End-to-end benchmark: ViT-B/16 forward throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "images/sec", "vs_baseline": N}

Baseline: the reference repo's own published numbers (BASELINE.md) put the
HF PyTorch GPU baseline at 80.3 ms for bs=32 on a 3080 Ti (= 398.5 img/s) —
the bar BASELINE.json says to beat; the reference's Triton path itself is
slower (104.8 ms). ``vs_baseline`` is ours / 398.5 (higher is better).

Timing uses the chained-scan slope method (see vit_tpu/utils/timing.py):
each iteration's input is data-dependent on the previous output, N1- and
N2-long chains run inside one jit, and the per-forward time is the slope,
so the fixed per-call host overhead cancels. The card's name and power
limit, the device JAX sees, and the rest of the detail (latency, batch
sweep) go to stderr; stdout carries exactly the one JSON line. Refuses to
run without an accelerator.
"""

from __future__ import annotations

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from vit_tpu.config import ViTConfig
from vit_tpu.models.vit import forward, init_params
from vit_tpu.utils.compile_cache import enable_compile_cache
from vit_tpu.utils.device import (describe, gpu_name_and_power_limit,
                                  require_accelerator)
from vit_tpu.utils.timing import bench_chained

HF_GPU_BS32_IMG_PER_SEC = 32 / 0.0803  # BASELINE.md: HF 80.3 ms @ bs=32


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def model_ms(cfg: ViTConfig, batch: int, *, reps: int = 5) -> float:
    """Steady-state per-forward milliseconds."""
    params = init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.standard_normal(
        (batch, 3, cfg.image_size, cfg.image_size)), cfg.dtype)

    def step(c, params, px):
        # Perturb the input by c*1e-30 (a live data dependency the compiler
        # cannot fold; numerically a no-op) and reduce the output to the
        # next carry so every chained forward is real and serialized.
        x = px * (1.0 + c * 1e-30).astype(cfg.dtype)
        out = forward(params, x, cfg)
        return jnp.mean(out).astype(jnp.float32)

    return bench_chained(step, reps=reps, args=(params, px))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true",
                    help="also run the reference's batch sweep to stderr")
    ap.add_argument("--no-quant", action="store_true",
                    help="skip the int8-tier sidecar measurement")
    args = ap.parse_args()

    enable_compile_cache()
    require_accelerator()
    log(f"card: {gpu_name_and_power_limit()}")
    log(f"device: {describe()} | dtype: {args.dtype}")

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    cfg = ViTConfig(dtype=dtype)

    # Headline: bs=32 throughput (BASELINE.json metric).
    ms = model_ms(cfg, args.batch, reps=args.reps)
    ips = args.batch / (ms / 1e3)
    log(f"bs={args.batch}: {ms:.3f} ms/forward -> {ips:.1f} img/s "
        f"(reference Triton bs=32: 104.8 ms, HF GPU: 80.3 ms)")

    # Secondary: single-image steady-state latency.
    l1 = model_ms(cfg, 1, reps=args.reps)
    log(f"bs=1: {l1:.3f} ms/forward "
        f"(reference Triton: 70.9 ms, HF GPU: 4.7 ms)")

    # Secondary: the int8 serving tier (docs/QUANT.md), reported as a
    # sidecar field; the headline stays the bf16 tier.
    int8_ips = None
    if not args.no_quant:
        from vit_tpu.quant import forward_quant, quantize_params
        qparams = quantize_params(init_params(jax.random.key(0), cfg))
        rng = np.random.default_rng(0)
        px = jnp.asarray(rng.standard_normal(
            (args.batch, 3, cfg.image_size, cfg.image_size)), cfg.dtype)

        def qstep(c, qparams, px):
            x = px * (1.0 + c * 1e-30).astype(cfg.dtype)
            out = forward_quant(qparams, x, cfg)
            return jnp.mean(out).astype(jnp.float32)

        qms = bench_chained(qstep, reps=args.reps, args=(qparams, px))
        int8_ips = round(args.batch / (qms / 1e3), 1)
        log(f"int8 tier bs={args.batch}: {qms:.3f} ms/forward -> "
            f"{int8_ips} img/s")

    if args.sweep:
        for b in [1, 2, 4, 8, 16, 24, 32, 48, 64]:
            s = model_ms(cfg, b, reps=args.reps)
            log(f"  sweep bs={b:3d}: {s:8.3f} ms  {b / (s / 1e3):9.1f} img/s")

    out = {
        "metric": f"vit_b16_images_per_sec_bs{args.batch}_{args.dtype}",
        "value": round(ips, 1),
        "unit": "images/sec",
        "vs_baseline": round(ips / HF_GPU_BS32_IMG_PER_SEC, 2),
    }
    if int8_ips is not None:
        out["int8_tier_images_per_sec"] = int8_ips
    print(json.dumps(out))


if __name__ == "__main__":
    main()
