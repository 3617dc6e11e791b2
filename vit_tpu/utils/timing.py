"""Timing + benchmark harness (reference vit/utils.py:136-191).

The reference times with CUDA events + ``torch.cuda.synchronize`` (``timed``)
and a 25-warmup / 100-rep median loop (``benchmark``). Under JAX the sync
boundary is ``jax.block_until_ready``: a call returns before the device
finishes, so every timing here ends in it. Two harnesses:

- :func:`do_bench` — wall-clock of one synced call. Includes the fixed
  host dispatch overhead; fine for comparing like with like, matches the
  reference's protocol (``triton.testing.do_bench`` medians, quantiles
  0.5/0.2/0.8).
- :func:`bench_chained` — steady-state per-iteration time: run the step
  N1 and N2 times *inside one jitted ``lax.scan``* (each iteration data-
  dependent on the last so XLA cannot hoist it), sync, and take the slope
  (T(N2)-T(N1))/(N2-N1). Fixed per-call overhead cancels; this is the
  device's time per forward.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import jax
import jax.numpy as jnp
import numpy as np


def _sync(out) -> None:
    """Wait until every array in ``out`` is computed."""
    jax.block_until_ready(out)


def timed(fn: Callable, *args, **kwargs):
    """One timed call incl. device sync -> (result, milliseconds).

    Mirrors reference vit/utils.py:181-191.
    """
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    return out, (time.perf_counter() - t0) * 1e3


def do_bench(fn: Callable, *, warmup: int = 10, reps: int = 30,
             quantiles=(0.5, 0.2, 0.8)) -> tuple[float, ...]:
    """Median (+ quantile) wall-clock ms of one synced ``fn()`` call — the
    role ``triton.testing.do_bench`` plays in every reference kernel
    ``__main__``. Includes fixed dispatch overhead; see module docstring."""
    for _ in range(warmup):
        _sync(fn())
    times = np.empty(reps)
    for i in range(reps):
        t0 = time.perf_counter()
        _sync(fn())
        times[i] = (time.perf_counter() - t0) * 1e3
    return tuple(float(np.quantile(times, q)) for q in quantiles)


class NoisyTimingError(RuntimeError):
    """The chained-slope fit could not produce a trustworthy positive time."""


def bench_chained(step: Callable, *,
                  lengths: tuple[int, ...] = (10, 60, 110), reps: int = 5,
                  warmup: int = 2, args: tuple = (),
                  max_rel_residual: float = 0.25,
                  min_span_ms: float = 20.0,
                  max_iters: int = 100_000) -> float:
    """Steady-state per-iteration milliseconds of ``step``.

    ``step``: traced fn ``(fp32 scalar carry, *args) -> fp32 scalar carry``.
    It must consume the carry in a way the compiler cannot fold (e.g.
    perturb an input by ``carry * 1e-30``) and produce a scalar derived from
    its real output, so every iteration is live and serialized.

    The per-iteration time is the least-squares slope of median wall-clock
    over >=3 chain lengths (a two-point min-of-reps difference is noise-
    dominated for sub-50us ops and can even go negative — round-1 artifacts
    published -97 TFLOP/s rows that way). Two trust checks, each triggering
    an automatic re-measure with scaled-up chain lengths:

    - **positivity + residual** of the line fit;
    - **span**: the modeled compute span ``slope x (max_len - min_len)``
      must exceed ``min_span_ms`` — a fit whose total signal is below the
      host's per-call jitter can be self-consistent yet wildly wrong.

    Raises :class:`NoisyTimingError` if no trustworthy positive slope can be
    obtained within ``max_iters``-long chains.

    Pass large operands (params, inputs) via ``args`` rather than closing
    over them: closed-over arrays are baked into the HLO as constants, which
    bloats every compile.
    """
    assert len(lengths) >= 2 and len(set(lengths)) == len(lengths), lengths

    def build(n: int):
        @jax.jit
        def g(c0, *a):
            def body(c, _):
                return step(c, *a), None
            c, _ = jax.lax.scan(body, c0, None, length=n)
            return c
        return g

    def measure(lens: tuple[int, ...], nreps: int) -> tuple[float, float]:
        """(slope_ms, relative_residual) from a least-squares line fit of
        median total seconds vs chain length."""
        med = {}
        c0 = jnp.float32(0.0)
        for n in lens:
            g = build(n)
            for _ in range(warmup):
                jax.device_get(g(c0, *args))  # compile + warm
            times = np.empty(nreps)
            for i in range(nreps):
                t0 = time.perf_counter()
                jax.device_get(g(c0, *args))
                times[i] = time.perf_counter() - t0
            med[n] = float(np.median(times))
        xs = np.asarray(lens, np.float64)
        ys = np.asarray([med[n] for n in lens], np.float64)
        slope, intercept = np.polyfit(xs, ys, 1)
        pred = slope * xs + intercept
        scale = max(abs(slope) * (xs.max() - xs.min()), 1e-12)
        resid = float(np.abs(ys - pred).max() / scale)
        return slope * 1e3, resid

    def scaled(lens: tuple[int, ...], f: float) -> tuple[int, ...]:
        out, prev = [], 0
        for n in lens:
            n = min(max(int(1 + (n - 1) * f), prev + 1), max_iters)
            out.append(n)
            prev = n
        return tuple(out)

    lens, nreps = tuple(lengths), reps
    for attempt in range(4):
        slope_ms, resid = measure(lens, nreps)
        span_ms = slope_ms * (max(lens) - min(lens))
        bad_fit = slope_ms <= 0 or (len(lens) > 2 and resid > max_rel_residual)
        too_short = 0 < span_ms < min_span_ms and max(lens) < max_iters
        if not bad_fit and not too_short:
            return slope_ms
        # Scale chains so the compute span comfortably exceeds the jitter.
        factor = (2.0 if slope_ms <= 0
                  else max(2.0, 2.0 * min_span_ms / max(span_ms, 1e-6)))
        lens = scaled(lens, factor)
        nreps = max(nreps, 5)
    slope_ms, _ = measure(lens, max(nreps, 7))
    if slope_ms <= 0:
        raise NoisyTimingError(
            f"non-positive per-iteration time {slope_ms:.6f} ms after "
            f"retries (lengths={lens}); the op is too fast/noisy for "
            f"this harness")
    return slope_ms


def benchmark_sweep(make_fns: Callable[[int], dict[str, Callable]],
                    sizes: Iterable[int], *, warmup: int = 10,
                    reps: int = 30):
    """Sweep a size axis comparing named implementations, yielding rows.

    The generator shape of reference vit/utils.py:136-178 ``benchmark``:
    for each size, build the competing callables, warm them up (compile),
    and report median/quantile ms per provider.

    Yields ``{"size": s, "<name>_ms": p50, "<name>_ms_lo": p20,
    "<name>_ms_hi": p80, ...}``.
    """
    for s in sizes:
        row: dict = {"size": s}
        for name, fn in make_fns(s).items():
            p50, p20, p80 = do_bench(fn, warmup=warmup, reps=reps)
            row[f"{name}_ms"] = p50
            row[f"{name}_ms_lo"] = p20
            row[f"{name}_ms_hi"] = p80
        yield row
