"""Shape tracing — the reference's ``tensor_info`` decorator, JAX-native.

The reference logs function entry/exit and every tensor arg/result shape via
loguru (reference vit/utils.py:18-42) with commented-out attach points at each
module forward. Here the decorator additionally wraps the call in
``jax.named_scope`` so the function shows up as a labeled region in
``jax.profiler`` traces — the equivalent of reading launch names in
nsight.
"""

from __future__ import annotations

import functools
import logging

import jax

logger = logging.getLogger("vit_tpu")


def _describe(x) -> str:
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return f"{tuple(x.shape)}:{x.dtype}"
    return repr(x)[:60]


def tensor_info(fn=None, *, name: str | None = None):
    """Log arg/result shapes and wrap in a profiler ``named_scope``.

    Usage::

        @tensor_info
        def encoder_block(x, ...): ...

    Mirrors reference vit/utils.py:18-42. Works on traced values (logs
    abstract shapes at trace time — once per compilation, not per step,
    which is the honest XLA semantics: there is no per-step host hook
    inside a jitted program).
    """
    def deco(f):
        scope = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            logger.info("%s <- %s", scope,
                        ", ".join(_describe(a) for a in args))
            with jax.named_scope(scope):
                out = f(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            logger.info("%s -> %s", scope,
                        ", ".join(_describe(o) for o in outs))
            return out

        return wrapper

    return deco(fn) if fn is not None else deco
