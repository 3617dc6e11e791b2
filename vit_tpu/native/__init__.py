"""Python bindings for the native (C++) tier.

Loads ``native/libmatmul_batch.so`` via ctypes and registers its XLA FFI
handler so jitted JAX programs can dispatch it on the CPU platform — the
framework's equivalent of the reference's lone native artifact
(reference examples/matmul_batch.cu; see native/matmul_batch.cc).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmatmul_batch.so")


def ensure_built() -> str:
    """Build the native library if missing or stale (idempotent).

    Staleness is keyed on source mtime vs .so mtime — a binary left over
    from another host (or an older source) is rebuilt, never trusted.
    Returns the library path.
    """
    src = os.path.join(_NATIVE_DIR, "matmul_batch.cc")
    stale = (not os.path.exists(_LIB_PATH)
             or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src))
    if stale:
        subprocess.run(["make", "-C", _NATIVE_DIR, "libmatmul_batch.so"],
                       check=True, capture_output=True)
    return _LIB_PATH


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(ensure_built())
    lib.vit_tpu_matmul_batch.restype = None
    lib.vit_tpu_matmul_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
    ]
    return lib


def matmul_batch_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Native batched matmul on numpy arrays.

    ``a``: (B, M, K) fp32; ``b``: (K, N) shared or (B, K, N) per-batch —
    the reference's matmul/matmul3 split in one entry point.
    """
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    assert a.ndim == 3 and b.ndim in (2, 3), (a.shape, b.shape)
    batch, m, k = a.shape
    b_batched = b.ndim == 3
    assert b.shape[-2] == k and (not b_batched or b.shape[0] == batch), (
        a.shape, b.shape)
    n = b.shape[-1]
    c = np.empty((batch, m, n), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    _lib().vit_tpu_matmul_batch(
        a.ctypes.data_as(fp), b.ctypes.data_as(fp), c.ctypes.data_as(fp),
        batch, m, k, n, int(b_batched))
    return c


@functools.cache
def _register_ffi() -> bool:
    """Register the XLA custom-call target (CPU platform). Returns success."""
    import jax

    lib = _lib()
    if not hasattr(lib, "MatmulBatch"):
        return False  # built without jaxlib headers
    jax.ffi.register_ffi_target(
        "vit_tpu_matmul_batch",
        jax.ffi.pycapsule(lib.MatmulBatch),
        platform="cpu")
    return True


def matmul_batch_jax(a, b):
    """The native kernel as an XLA custom call inside a jittable program.

    CPU platform only (on an accelerator the model's matmuls are XLA's
    library GEMMs); raises if the FFI handler is unavailable.
    """
    import jax
    import jax.numpy as jnp

    if not _register_ffi():
        raise RuntimeError("native library built without XLA FFI support")
    batch, m, _ = a.shape
    n = b.shape[-1]
    call = jax.ffi.ffi_call(
        "vit_tpu_matmul_batch",
        jax.ShapeDtypeStruct((batch, m, n), jnp.float32))
    return call(a, b)
