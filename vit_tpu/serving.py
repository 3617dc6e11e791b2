"""Fixed-shape batch serving, single-chip or over a device mesh.

The reference's roadmap items 3-4 ("Given a batch size, fix all the tensor
sizes", "Use CUDA graphs to optimize kernel dispatch time" — reference
README.md:28-29) exist because dynamic shapes force per-op dispatch. Under
XLA the constraint is structural: every ``jit`` program is compiled for one
shape. This module turns that into a serving layer:

- :class:`Predictor` owns one compiled executable per bucket batch size
  (compile-once, reuse forever — the CUDA-graph replay equivalent).
- Arbitrary request sizes are served by greedily decomposing onto buckets
  (largest-first) and padding the remainder up to the smallest bucket that
  fits, slicing pad rows off the result. Padding is exact for ViT: images
  don't attend to each other, so pad images never influence real outputs.
- ``mesh=`` fans a bucket out across devices (SURVEY.md §2.6): the forward
  runs under plain GSPMD (batch-DP x Megatron-TP, collectives inserted by
  XLA).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vit_tpu.config import ViTConfig
from vit_tpu.models.vit import Params, forward

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class Predictor:
    """Compiled fixed-shape forward passes over a set of batch buckets.

    >>> pred = Predictor(params, cfg, buckets=(1, 8, 32))
    >>> out = pred(images)         # any leading batch size

    With a mesh, buckets are rounded up to multiples of the 'data' axis so
    every device gets an equal shard:

    >>> mesh = make_mesh(data=4, model=2)
    >>> pred = Predictor(params, cfg, buckets=(8, 64), mesh=mesh)
    """

    def __init__(self, params: Params, cfg: ViTConfig,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, *,
                 precompile: bool = False, mesh: Mesh | None = None,
                 quant: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        assert buckets and all(b > 0 for b in buckets)

        if quant:
            # Int8 tier (vit_tpu/quant.py): quantize once at construction,
            # serve the quantized pytree. On a mesh it shards like the float
            # rules (param_shardings understands quantized kernels: int8
            # weights Megatron-split, scales follow the output dim).
            from vit_tpu.quant import forward_quant, quantize_params
            params = quantize_params(params)

            def fwd(p, x):
                return forward_quant(p, x, cfg)
        else:
            def fwd(p, x):
                return forward(p, x, cfg)

        self._fwd = fwd
        self._plan_fns: dict = {}
        if mesh is None:
            self.buckets = tuple(sorted(set(buckets)))
            self.params = params
            self._in_sharding = None
        else:
            from vit_tpu.parallel import batch_sharding, param_shardings
            data = mesh.shape["data"]
            self.buckets = tuple(sorted({-(-b // data) * data
                                         for b in buckets}))
            self._in_sharding = batch_sharding(mesh)
            self.params = jax.device_put(
                params, param_shardings(params, mesh, cfg))

        if precompile:
            # Compile (and run once) the executor each single-bucket
            # request uses, so the first real request of that size is warm.
            for b in self.buckets:
                self(jnp.zeros((b, cfg.num_channels, cfg.image_size,
                                cfg.image_size), cfg.dtype))

    def _plan(self, n: int) -> list[int]:
        """Decompose n onto buckets, largest-first; the tail rounds up to
        the smallest bucket that fits (pad)."""
        plan, rest = [], n
        for b in reversed(self.buckets):
            while rest >= b:
                plan.append(b)
                rest -= b
        if rest:
            plan.append(min(b for b in self.buckets if b >= rest))
        return plan

    def _plan_executor(self, sig: tuple[int, ...]):
        """ONE jitted executable for a whole bucket plan: each group of
        same-size chunks runs under ``lax.map`` (the per-bucket program is
        traced once and iterated), groups run back to back, and the results
        come back concatenated. A request is then a single dispatch instead
        of one per chunk, so the host's per-call cost is paid once per
        request. The padded input buffer is donated on accelerators (the
        caller-visible array is always framework-owned, see ``__call__``);
        XLA can only alias it to an output of the same shape, and no output
        has one, so on the GPU it reports the buffer unusable (PERF.md §7).

        On a mesh the same executor wraps the GSPMD forward: chunks are
        re-constrained to the batch sharding after each slice so the
        per-bucket programs see their expected layouts."""
        groups: list[list[int]] = []
        for b in sig:
            if groups and groups[-1][0] == b:
                groups[-1][1] += 1
            else:
                groups.append([b, 1])
        raw = self._fwd
        batch_ns = self._in_sharding
        stacked_ns = (None if self.mesh is None else
                      NamedSharding(self.mesh, P(None, "data")))

        def run(params, padded):
            outs, off = [], 0
            for b, k in groups:
                seg = jax.lax.slice_in_dim(padded, off, off + k * b)
                if k == 1:
                    if batch_ns is not None:
                        seg = jax.lax.with_sharding_constraint(seg, batch_ns)
                    res = raw(params, seg)
                else:
                    seg = seg.reshape(k, b, *padded.shape[1:])
                    if stacked_ns is not None:
                        seg = jax.lax.with_sharding_constraint(seg,
                                                               stacked_ns)
                    res = jax.lax.map(lambda ch: raw(params, ch), seg)
                    res = res.reshape(k * b, *res.shape[2:])
                outs.append(res)
                off += k * b
            return outs[0] if len(outs) == 1 else jnp.concatenate(outs, 0)

        # Donation is a no-op (plus a warning) on the CPU backend, which has
        # no buffer aliasing — donate on every accelerator.
        donate = (1,) if jax.default_backend() != "cpu" else ()
        return jax.jit(run, donate_argnums=donate)

    def __call__(self, images) -> jax.Array:
        given = images
        images = jnp.asarray(images, self.cfg.dtype)
        n = images.shape[0]
        assert n > 0, "empty batch"

        plan = tuple(self._plan(n))
        fn = self._plan_fns.get(plan)
        if fn is None:
            fn = self._plan_fns[plan] = self._plan_executor(plan)
        total = sum(plan)
        if total > n:
            pad = jnp.zeros((total - n, *images.shape[1:]),
                            self.cfg.dtype)
            images = jnp.concatenate([images, pad], axis=0)
        elif images is given:
            # The executor donates its input; never donate a buffer the
            # caller still owns. One async device copy buys safety.
            images = jnp.copy(images)
        if self._in_sharding is not None:
            # Mesh path: ship the whole padded request out batch-sharded
            # ONCE; the plan executor slices/reshapes on device.
            images = jax.device_put(images, self._in_sharding)
        out = fn(self.params, images)
        return out if total == n else out[:n]
