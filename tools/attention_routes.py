"""Time the candidate attention routes inside the full bf16 forward.

    python tools/attention_routes.py [--reps 7] [--iters 20] [--json PATH]

Routes, each swapped in for :func:`vit_tpu.ops.attention` while the rest of
``models.vit.forward`` stays as it is:

- ``xla``    — the plain chain ``ops.reference.attention`` (fp32 scores and
               bf16 probabilities in device memory, every layer);
- ``cudnn``  — ``jax.nn.dot_product_attention(implementation="cudnn")``,
               cuDNN's fused attention reached through XLA (the route
               ``ops.attention`` takes for bf16 on a GPU);
- ``triton`` — the installed library kernel
               ``jax.experimental.pallas.ops.gpu.attention.mha`` (JAX's
               own Pallas kernel on the Triton route, not one this
               repository wrote), with S padded to its power-of-two blocks
               and the pad keys masked through ``segment_ids``.

Cells: B/16 at bs=1 and bs=32 (S=197) and L/16-384 at bs=8 (S=577). Each
timed call runs ``--iters`` chained forwards inside one jitted
``lax.scan`` and ends in ``block_until_ready``; the routes take turns
within each repetition, and the median per forward is reported beside the
card's name and power limit. Each route's output is also compared with the
``xla`` route's. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from vit_tpu import ops
from vit_tpu.config import VARIANTS
from vit_tpu.models import vit
from vit_tpu.utils.compile_cache import enable_compile_cache
from vit_tpu.utils.device import (describe, gpu_name_and_power_limit,
                                  require_accelerator)

CELLS = (("B/16", 1), ("B/16", 32), ("L/16-384", 8))


def attention_triton(q, k, v, *, scale=None, block: int = 64):
    """The library's Triton-route kernel on (B, S, H, d) operands: pad S up
    to a multiple of ``block`` and give the pad tokens their own segment,
    so no real query attends to a pad key."""
    from jax.experimental.pallas.ops.gpu.attention import BlockSizes, mha

    b, s, _, d = q.shape
    sp = -(-s // block) * block
    pad = ((0, 0), (0, sp - s), (0, 0), (0, 0))
    seg = jnp.broadcast_to((jnp.arange(sp) >= s).astype(jnp.int32), (b, sp))
    out = mha(jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad), seg,
              sm_scale=d ** -0.5 if scale is None else scale,
              block_sizes=BlockSizes(block_q=block, block_k=block))
    return out[:, :s]


ROUTES = {
    "xla": lambda q, k, v, *, scale=None: ops._plain_attention(
        q, k, v, q.shape[-1] ** -0.5 if scale is None else scale),
    "cudnn": lambda q, k, v, *, scale=None: ops._cudnn_attention(
        q, k, v, q.shape[-1] ** -0.5 if scale is None else scale),
    "triton_b64": attention_triton,
    "triton_b128": lambda q, k, v, *, scale=None: attention_triton(
        q, k, v, scale=scale, block=128),
}


def chained_forward(cfg, route, iters: int):
    """jit: ``iters`` forwards, each input perturbed by the last output."""
    attn = ROUTES[route]

    def run(params, px):
        orig = ops.attention
        ops.attention = attn
        try:
            def body(c, _):
                x = px * (1.0 + c * 1e-30).astype(cfg.dtype)
                out = vit.forward(params, x, cfg)
                return jnp.mean(out).astype(jnp.float32), None
            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=iters)
            return c, vit.forward(params, px, cfg)
        finally:
            ops.attention = orig

    return jax.jit(run)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    enable_compile_cache()
    require_accelerator()
    card = gpu_name_and_power_limit()
    print(f"card: {card}\ndevice: {describe()}", flush=True)
    rows = []
    for name, batch in CELLS:
        cfg = VARIANTS[name].replace(dtype=jnp.bfloat16)
        params = vit.init_params(jax.random.key(0), cfg)
        rng = np.random.default_rng(0)
        px = jnp.asarray(rng.standard_normal(
            (batch, 3, cfg.image_size, cfg.image_size)), cfg.dtype)
        fns, outs, times = {}, {}, {}
        for route in ROUTES:
            fn = chained_forward(cfg, route, args.iters)
            t0 = time.perf_counter()
            try:
                _, outs[route] = jax.block_until_ready(fn(params, px))
            except Exception as e:  # a route the card refuses is a finding
                print(f"{name} bs={batch} {route}: failed: "
                      f"{type(e).__name__}: {str(e)[:300]}", flush=True)
                rows.append({"variant": name, "batch": batch,
                             "route": route, "error": str(e)[:300]})
                continue
            print(f"{name} bs={batch} {route}: compiled+ran in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            fns[route], times[route] = fn, []
        for _ in range(args.reps):
            for route, fn in fns.items():
                t0 = time.perf_counter()
                jax.block_until_ready(fn(params, px))
                times[route].append((time.perf_counter() - t0) * 1e3
                                    / (args.iters + 1))
        for route, ts in times.items():
            ms = float(np.median(ts))
            diff = float(np.max(np.abs(
                np.asarray(outs[route], np.float32)
                - np.asarray(outs["xla"], np.float32))))
            row = {"variant": name, "batch": batch, "seq_len": cfg.seq_len,
                   "route": route, "ms_per_forward": ms,
                   "ms_min": float(np.min(ts)), "ms_max": float(np.max(ts)),
                   "img_per_s": batch / (ms / 1e3),
                   "max_abs_vs_xla": diff, "card": card}
            rows.append(row)
            print(f"{name:<9} bs={batch:<3} {route:<12} "
                  f"{ms:9.4f} ms/forward  [{row['ms_min']:.4f}, "
                  f"{row['ms_max']:.4f}]  {row['img_per_s']:10.1f} img/s  "
                  f"max|diff| vs xla {diff:.3e}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
