"""End-to-end model benchmark sweep (reference vit/vit.py:296-327).

Runs the reference's batch-size sweep [1,2,4,8,16,24,32,48,64] on the
flagship ViT-B/16 (or any variant) and writes ``benchmarks/model/
Performance.csv`` + ``.png`` in the reference's artifact layout, with the
reference's own published GPU numbers (BASELINE.md) as comparison columns.

The sweep is DRIFT-GATED against the committed artifact (round-4 lesson:
a single noisy run published as the flagship table): any row deviating
more than ``DRIFT_GATE_PCT`` from the committed CSV is automatically
re-measured twice more and the median of the three published, with the
disagreement logged. Rows the committed CSV has but this run did not
measure are CARRIED FORWARD, never silently dropped (a targeted
``--batches 32`` refresh must not lose the bs=128 row).

Run: ``python -m vit_tpu.bench.model [--variant B/16] [--dtype bfloat16]
[--quant]``. Refuses to run without an accelerator.
"""

from __future__ import annotations

import argparse
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np

from vit_tpu.bench.artifacts import write_perf_report
from vit_tpu.config import VARIANTS
from vit_tpu.models.vit import forward, init_params
from vit_tpu.utils.compile_cache import enable_compile_cache
from vit_tpu.utils.device import require_accelerator
from vit_tpu.utils.timing import bench_chained

#: The reference's published end-to-end ms (3080 Ti, fp32) — BASELINE.md.
REFERENCE_MS = {
    1: {"triton_gpu": 70.9, "hf_gpu": 4.7},
    8: {"triton_gpu": 69.6, "hf_gpu": 21.0},
    16: {"triton_gpu": 71.9, "hf_gpu": 43.2},
    32: {"triton_gpu": 104.8, "hf_gpu": 80.3},
    64: {"triton_gpu": 260.6, "hf_gpu": 161.5},
    # Older-run rows (reference benchmarks/model/benchmark.csv:6-7).
    128: {"triton_gpu": 490.6, "hf_gpu": 318.7},
    256: {"triton_gpu": 1140.0, "hf_gpu": 629.1},
}

BATCH_SWEEP = [1, 2, 4, 8, 16, 24, 32, 48, 64]

#: Deviation from the committed CSV (either direction) past which a row is
#: re-measured before being published: it catches both regressions and
#: too-good-to-be-true outliers while letting steady rows through on one
#: measurement.
DRIFT_GATE_PCT = 8.0


def read_committed(name: str, out_root: str = "benchmarks") -> dict[int, dict]:
    """The committed artifact's rows, ``{batch: row}`` (floats parsed)."""
    path = os.path.join(out_root, name, "Performance.csv")
    rows: dict[int, dict] = {}
    try:
        with open(path, newline="") as f:
            for r in csv.DictReader(f):
                try:
                    b = int(r["batch"])
                except (KeyError, ValueError):
                    continue
                parsed = {}
                for k, v in r.items():
                    if v is None or v == "":
                        continue
                    try:
                        parsed[k] = int(v) if k == "batch" else float(v)
                    except ValueError:
                        parsed[k] = v
                rows[b] = parsed
    except OSError:
        pass
    return rows


def forward_tflops(cfg, batch: int) -> float:
    """Per-forward useful work in TFLOP, 2*MAC, over the tokens the program
    computes (``cfg.seq_len``: 197 for B/16 — the forward runs unpadded)."""
    s = cfg.seq_len
    m, d, mlp = batch * s, cfg.hidden_dim, cfg.mlp_dim
    per_layer = 8 * m * d * d + 4 * m * s * d + 4 * m * d * mlp
    embed = 2 * batch * cfg.num_patches * cfg.patch_dim * d
    return (cfg.num_layers * per_layer + embed) / 1e12


def sweep(variant: str = "B/16", dtype=jnp.bfloat16,
          batches=BATCH_SWEEP, reps: int = 5, quant: bool = False,
          committed: dict[int, dict] | None = None):
    """``committed``: the current artifact's rows (``read_committed``);
    when given, rows deviating > ``DRIFT_GATE_PCT`` are re-measured twice
    and the median published."""
    cfg = VARIANTS[variant].replace(dtype=dtype)
    params = init_params(jax.random.key(0), cfg)
    if quant:
        from vit_tpu.quant import forward_quant, quantize_params
        params = quantize_params(params)
    rng = np.random.default_rng(0)
    rows = []
    for b in batches:
        px = jnp.asarray(rng.standard_normal(
            (b, 3, cfg.image_size, cfg.image_size)), cfg.dtype)

        def step(c, params, px):
            x = px * (1.0 + c * 1e-30).astype(cfg.dtype)
            out = (forward_quant(params, x, cfg) if quant else
                   forward(params, x, cfg))
            return jnp.mean(out).astype(jnp.float32)

        ms = bench_chained(step, reps=reps, args=(params, px))
        old = (committed or {}).get(b, {}).get("ms")
        if old:
            drift = abs(ms - old) / old * 100
            if drift > DRIFT_GATE_PCT:
                print(f"  [drift gate] bs={b}: {ms:.3f} ms vs committed "
                      f"{old:.3f} ({drift:+.1f}%) — re-measuring x2",
                      flush=True)
                tries = [ms]
                for _ in range(2):
                    tries.append(bench_chained(step, reps=reps,
                                               args=(params, px)))
                tries.sort()
                ms = tries[1]  # median of 3
                print(f"  [drift gate] bs={b}: measurements "
                      f"{[round(t, 3) for t in tries]} -> median {ms:.3f}",
                      flush=True)
        tf = forward_tflops(cfg, b) / (ms / 1e3)
        row = {"batch": b, "ms": round(ms, 3),
               "img_per_s": round(b / (ms / 1e3), 1),
               "tflops": round(tf, 1)}
        row.update(REFERENCE_MS.get(b, {}))
        rows.append(row)
        print(row, flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="B/16", choices=sorted(VARIANTS))
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batches", type=int, nargs="+", default=None,
                    help="batches to (re-)measure; default = the standard "
                         "sweep UNION the committed CSV's batches. Rows "
                         "the committed CSV has that are not re-measured "
                         "are carried forward, never dropped")
    ap.add_argument("--quant", action="store_true",
                    help="int8 quantized tier (vit_tpu.quant)")
    args = ap.parse_args()

    name = "model" if args.variant == "B/16" else \
        f"model_{args.variant.replace('/', '_')}"
    if args.dtype != "bfloat16":
        # Keep the bf16 headline artifact (benchmarks/model/) from being
        # overwritten by fp32 or other-dtype runs.
        name = f"{name}_{args.dtype}"
    if args.quant:
        name = f"{name}_int8"

    committed = read_committed(name)
    batches = args.batches
    if batches is None:
        batches = sorted(set(BATCH_SWEEP) | set(committed))

    enable_compile_cache()
    require_accelerator()
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    rows = sweep(args.variant, dtype, batches=batches, reps=args.reps,
                 quant=args.quant, committed=committed)
    # Row preservation: carry forward committed rows for batches this run
    # did not measure (a targeted refresh must never shrink the artifact).
    measured = {r["batch"] for r in rows}
    carried = [committed[b] for b in sorted(committed) if b not in measured]
    if carried:
        print(f"carrying forward committed rows for batches "
              f"{[r['batch'] for r in carried]}")
    rows = sorted(rows + carried, key=lambda r: r["batch"])
    out = write_perf_report(name, rows, x_key="batch",
                            y_keys=["ms"], y_label="ms")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
