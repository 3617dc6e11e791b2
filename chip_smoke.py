"""Smoke run of the system's main path on one NVIDIA GPU, at full width.

    python chip_smoke.py            # one card: six phases
    python chip_smoke.py --multi    # four cards: the mesh path only

One process drives the card(s) through the entry points a user calls —
``models.vit.forward``, ``serving.Predictor``, ``quant.forward_quant`` and
``train.make_train_step`` — with random weights made from seeds, and checks
every result against the repository's own plain reference:

1. golden, fp32: B/16 on the synthetic HF checkpoint vs the hidden states
   recorded through torch (tests/fixtures/golden_b16.npz), max|diff| < 1e-3
   (BASELINE.json), at ``Precision.HIGHEST`` (no TF32);
2. serving, bf16: ``Predictor(buckets=(1, 8, 32))`` answers 1, 5, 32 and 37
   images; each answer is within 0.15 max-abs of the fp32 forward
   (tests/test_bf16_parity.py's bar: bf16 keeps 8 mantissa bits);
3. attention: the route the platform chose vs ``reference.attention`` at
   S = 197, 257 (head dim 80) and 577, bf16;
4. int8: ``forward_quant`` at B/16 bs=32 vs the float forward, relative
   error < 5e-2 in fp32 (tests/test_quant.py) and < 6e-2 in bf16;
5. training: three bf16 B/16 steps at bs=8, finite loss;
6. variants: every ``config.VARIANTS`` entry, one bf16 bs=2 forward at its
   published width vs its fp32 forward.

``--multi`` runs only the multi-device path users call — ``Predictor`` on a
4x1 and a 2x2 mesh at full B/16 bf16, and one 2x2 DP x TP train step —
each against its single-device counterpart.

Refuses to run (non-zero exit, no result line) unless JAX's default backend
is a GPU. Any failed check raises, so any failed phase exits non-zero. The
card's name and power limit come first; the last stdout line is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from vit_tpu import ops
from vit_tpu.config import VARIANTS, ViTConfig
from vit_tpu.models.vit import forward, forward_with_intermediates, init_params
from vit_tpu.ops import reference
from vit_tpu.parallel import batch_sharding, make_mesh, param_shardings
from vit_tpu.quant import forward_quant, quantize_params
from vit_tpu.serving import Predictor
from vit_tpu.train import cross_entropy_loss, make_train_step
from vit_tpu.utils.compile_cache import enable_compile_cache
from vit_tpu.utils.device import describe, gpu_name_and_power_limit
from vit_tpu.weights import params_from_state_dict
from vit_tpu.weights.synthetic import golden_pixels, synthetic_hf_state_dict

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "golden_b16.npz")

#: Tolerances, each with its source.
GOLDEN_TOL = 1e-3      # BASELINE.json parity bar, fp32
BF16_TOL = 0.15        # tests/test_bf16_parity.py: bf16 vs the fp32 oracle
ATTN_TOL = 2e-2        # bf16 operands; see phase_attention
INT8_TOL = 5e-2        # tests/test_quant.py, fp32 relative error
INT8_BF16_TOL = 6e-2   # tests/test_quant.py::test_forward_quant_bf16
# Mesh vs one device, bf16: the sharded program sums in another order (TP
# partial sums) and rounds to bf16 (8 mantissa bits) at other points, so
# the two runs differ like two bf16 approximations of the same fp32 result:
# about 1e-2 relative in hidden states and gradient tensors, 1e-3 in the
# loss (~7). Each mesh answer is also held to BF16_TOL against fp32.
MULTI_REL_TOL = 5e-2
MULTI_LOSS_TOL = 2e-2
MULTI_GRAD_TOL = 5e-2


def log(*a) -> None:
    print(*a, flush=True)


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check(name: str, value: float, tol: float) -> None:
    ok = np.isfinite(value) and value < tol
    log(f"  {name}: {value:.3e} (< {tol:g}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} = {value} not < {tol}")


def _images(cfg, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.num_channels, cfg.image_size, cfg.image_size)).astype(
            np.float32)


def golden_params(cfg, seed: int):
    """The synthetic HF checkpoint (seeded) through the import path."""
    return params_from_state_dict(synthetic_hf_state_dict(cfg, seed=seed),
                                  cfg)


def phase_golden(fixture, cfg) -> None:
    """fp32 forward and per-layer capture vs the torch recording."""
    params = golden_params(cfg, int(fixture["weights_seed"]))
    px = jnp.asarray(golden_pixels(cfg, batch=fixture["final_hidden"].shape[0],
                                   seed=int(fixture["pixels_seed"])))
    out = jax.jit(lambda p, x: forward(p, x, cfg))(params, px)
    assert out.shape == fixture["final_hidden"].shape, out.shape
    _check("final max|diff| vs torch", _max_abs(out, fixture["final_hidden"]),
           GOLDEN_TOL)
    _, hiddens = jax.jit(lambda p, x: forward_with_intermediates(p, x, cfg))(
        params, px)
    mid = int(fixture["mid_layer"])
    _check(f"layer {mid} max|diff| vs torch",
           _max_abs(hiddens[mid], fixture["mid_hidden"]), GOLDEN_TOL)


def phase_serving(cfg32, params32, *, buckets=(1, 8, 32),
                  sizes=(1, 5, 32, 37), seed: int = 11) -> None:
    """bf16 Predictor answers vs the fp32 forward on the same weights."""
    cfg16 = cfg32.replace(dtype=jnp.bfloat16)
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params32)
    imgs = _images(cfg32, max(sizes), seed)
    want = np.asarray(jax.jit(lambda p, x: forward(p, x, cfg32))(
        params32, jnp.asarray(imgs)))
    pred = Predictor(params16, cfg16, buckets=buckets)
    for n in sizes:
        t0 = time.perf_counter()
        got = pred(imgs[:n])
        got = np.asarray(got, np.float32)
        ms = (time.perf_counter() - t0) * 1e3
        assert got.shape == want[:n].shape, (got.shape, want[:n].shape)
        _check(f"{n:>3} images (plan {pred._plan(n)}, first call "
               f"{ms:.0f} ms) max|diff| vs fp32", _max_abs(got, want[:n]),
               BF16_TOL)
    big = max(buckets)
    exe = pred._plan_fns[(big,)].lower(
        pred.params, jax.ShapeDtypeStruct(imgs[:big].shape, cfg16.dtype)
    ).compile()
    log(f"  bs={big} executable memory_analysis: {exe.memory_analysis()}")


def phase_attention(*, batch: int = 4,
                    shapes=((197, 12, 64), (257, 16, 80), (577, 16, 64)),
                    seed: int = 5) -> None:
    """The platform's bf16 attention route vs the plain chain.

    Tolerance 2e-2 absolute: both routes take bf16 q/k/v, accumulate in
    fp32 and round the probabilities to bf16 (8 mantissa bits, 2^-9
    relative) before the probability x value product; outputs are O(1),
    and the routes differ in summation order and in when the softmax is
    normalised. Both are also held to the same bar against the fp32 chain
    on the same bf16 inputs.
    """
    rng = np.random.default_rng(seed)
    bhsd = (0, 2, 1, 3)
    for s, h, d in shapes:
        q, k, v = (jnp.asarray(rng.standard_normal((batch, s, h, d)),
                               jnp.bfloat16) for _ in range(3))
        got = jax.jit(ops.attention)(q, k, v)
        plain = jax.jit(lambda q, k, v: reference.attention(
            q.transpose(bhsd), k.transpose(bhsd),
            v.transpose(bhsd)).transpose(bhsd))
        want16 = plain(q, k, v)
        want32 = plain(*(a.astype(jnp.float32) for a in (q, k, v)))
        assert got.shape == q.shape and got.dtype == q.dtype
        tag = f"S={s} H={h} d={d} route={ops.attention_route(q.dtype)}"
        _check(f"{tag} vs bf16 chain", _max_abs(got, want16), ATTN_TOL)
        _check(f"{tag} vs fp32 chain", _max_abs(got, want32), ATTN_TOL)
        _check(f"{tag} bf16 chain vs fp32 chain", _max_abs(want16, want32),
               ATTN_TOL)


def phase_int8(cfg32, params32, *, batch: int = 32, seed: int = 13) -> None:
    """forward_quant vs the float forward, fp32 and bf16."""
    imgs = jnp.asarray(_images(cfg32, batch, seed))
    for cfg, tol in ((cfg32, INT8_TOL),
                     (cfg32.replace(dtype=jnp.bfloat16), INT8_BF16_TOL)):
        params = jax.tree.map(lambda a: a.astype(cfg.dtype), params32)
        want = jax.jit(lambda p, x: forward(p, x, cfg))(
            params, imgs.astype(cfg.dtype))
        got = jax.jit(lambda p, x: forward_quant(p, x, cfg))(
            quantize_params(params), imgs.astype(cfg.dtype))
        assert got.shape == want.shape, (got.shape, want.shape)
        _check(f"{jnp.dtype(cfg.dtype).name} bs={batch} relative error vs "
               f"float forward", _rel(got, want), tol)


def phase_training(cfg, *, batch: int = 8, steps: int = 3,
                   seed: int = 17) -> None:
    """make_train_step on one device: every loss finite, params move."""
    params = init_params(jax.random.key(seed), cfg)
    first = np.asarray(params["encoder"]["fc1"]["kernel"], np.float32)
    rng = np.random.default_rng(seed)
    init_fn, step_fn = make_train_step(cfg)
    opt_state = init_fn(params)
    for i in range(steps):
        px = jnp.asarray(_images(cfg, batch, seed + i), cfg.dtype)
        labels = jnp.asarray(rng.integers(0, cfg.num_classes, (batch,)),
                             jnp.int32)
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, px, labels)
        loss = float(loss)
        log(f"  step {i}: loss {loss:.4f} "
            f"({(time.perf_counter() - t0) * 1e3:.0f} ms incl. compile)")
        if not np.isfinite(loss):
            raise AssertionError(f"non-finite loss at step {i}: {loss}")
    moved = _max_abs(params["encoder"]["fc1"]["kernel"], first)
    if not moved > 0:
        raise AssertionError("training steps left the weights unchanged")


def phase_variants(variants, *, batch: int = 2, seed: int = 19) -> None:
    """Each variant: bf16 forward vs its fp32 forward, same weights."""
    for name, cfg32 in variants.items():
        params32 = init_params(jax.random.key(seed), cfg32)
        cfg16 = cfg32.replace(dtype=jnp.bfloat16)
        params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params32)
        imgs = jnp.asarray(_images(cfg32, batch, seed))
        want = jax.jit(lambda p, x: forward(p, x, cfg32))(params32, imgs)
        got = jax.jit(lambda p, x: forward(p, x, cfg16))(
            params16, imgs.astype(jnp.bfloat16))
        assert got.shape == want.shape, (name, got.shape, want.shape)
        _check(f"{name:<9} S={cfg32.seq_len} D={cfg32.hidden_dim} "
               f"L={cfg32.num_layers} out{tuple(got.shape)} bf16 vs fp32",
               _max_abs(got, want), BF16_TOL)


def phase_multi(cfg16, *, meshes=((4, 1), (2, 2)), batch: int = 32,
                train_batch: int = 8, seed: int = 23) -> None:
    """Mesh serving and a DP x TP train step vs one device."""
    params = init_params(jax.random.key(seed), cfg16)
    imgs = _images(cfg16, batch + 5, seed)
    cfg32 = cfg16.replace(dtype=jnp.float32)
    want32 = jax.jit(lambda p, x: forward(p, x, cfg32))(
        jax.tree.map(lambda a: a.astype(jnp.float32), params),
        jnp.asarray(imgs))
    single = np.asarray(Predictor(params, cfg16, buckets=(8, batch))(imgs),
                        np.float32)
    for data, model in meshes:
        mesh = make_mesh(data=data, model=model)
        pred = Predictor(params, cfg16, buckets=(8, batch), mesh=mesh)
        got = np.asarray(pred(imgs), np.float32)
        tag = f"Predictor mesh {data}x{model} ({len(imgs)} images)"
        _check(f"{tag} relative error vs one device", _rel(got, single),
               MULTI_REL_TOL)
        _check(f"{tag} max|diff| vs fp32 forward", _max_abs(got, want32),
               BF16_TOL)

    tcfg = cfg16.replace(num_classes=1000)
    tparams = init_params(jax.random.key(seed + 1), tcfg)
    rng = np.random.default_rng(seed)
    px = jnp.asarray(_images(tcfg, train_batch, seed), tcfg.dtype)
    labels = jnp.asarray(rng.integers(0, 1000, (train_batch,)), jnp.int32)
    # Loss and gradients before AdamW, whose normalised update would hide a
    # gradient difference; then one real step on the mesh.
    vg = jax.jit(jax.value_and_grad(
        functools.partial(cross_entropy_loss, cfg=tcfg)))
    loss1, grads1 = vg(tparams, px, labels)
    mesh = make_mesh(data=2, model=2)
    sp = jax.device_put(tparams, param_shardings(tparams, mesh, tcfg))
    spx = jax.device_put(px, batch_sharding(mesh))
    slab = jax.device_put(labels, batch_sharding(mesh))
    loss2, grads2 = vg(sp, spx, slab)
    _check("train 2x2 loss |diff| vs one device",
           abs(float(loss2) - float(loss1)), MULTI_LOSS_TOL)
    worst = max(_rel(a, b) for a, b in zip(jax.tree.leaves(grads2),
                                           jax.tree.leaves(grads1)))
    _check("train 2x2 worst per-tensor gradient relative error vs one "
           "device", worst, MULTI_GRAD_TOL)
    init_fn, step_fn = make_train_step(tcfg)
    _, _, loss = step_fn(sp, init_fn(sp), spx, slab)
    _check("train 2x2 step loss |diff| vs one device",
           abs(float(loss) - float(loss1)), MULTI_LOSS_TOL)


def run_phase(name: str, fn, *args, **kwargs) -> None:
    log(f"phase {name}")
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    log(f"phase {name}: passed in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default backend is "
              f"{backend!r}", file=sys.stderr)
        return 2

    log(f"cache: {enable_compile_cache()}")
    log(f"card: {gpu_name_and_power_limit()}")
    log(f"device: {describe()}")
    log(f"attention route: bf16={ops.attention_route(jnp.bfloat16)} "
        f"fp32={ops.attention_route(jnp.float32)}")
    t0 = time.perf_counter()
    cfg32 = ViTConfig()
    if args.multi:
        if len(jax.devices()) < 4:
            raise SystemExit(f"--multi needs 4 devices, "
                             f"have {len(jax.devices())}")
        run_phase("multi", phase_multi, cfg32.replace(dtype=jnp.bfloat16))
    else:
        fixture = np.load(FIXTURE)
        params32 = golden_params(cfg32, int(fixture["weights_seed"]))
        run_phase("1 golden fp32", phase_golden, fixture, cfg32)
        run_phase("2 serving bf16", phase_serving, cfg32, params32)
        run_phase("3 attention", phase_attention)
        run_phase("4 int8", phase_int8, cfg32, params32)
        run_phase("5 training", phase_training,
                  ViTConfig(dtype=jnp.bfloat16, num_classes=1000))
        run_phase("6 variants", phase_variants, VARIANTS)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
