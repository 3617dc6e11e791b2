"""Minimal matmul in Pallas on the Triton route — the educational piece.

Counterpart of the reference's blog-post example (reference
examples/matmul_batch.py:5-139: a fixed-block, non-autotuned Triton matmul
with an allclose test), written in Pallas for the GPU's Triton route. The
bare essentials, with none of the machinery a production GEMM needs:

- a kernel is a Python function over references to one block of each
  operand; ``pl.pallas_call`` runs one program per grid point;
- the grid tiles the output; BlockSpecs map grid positions to tiles, and
  Triton wants every block dimension to be a power of two;
- a loop inside the block walks K (blocks run in parallel, in no order, so
  nothing carries over between grid steps), and ``pl.dot`` with an fp32
  accumulator reaches the tensor cores.

Run: ``python examples/minimal_pallas_matmul.py`` — compiled for the GPU
through Triton when JAX's backend is a GPU, in Pallas's interpreter on the
CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BM = BN = 64  # output tile
BK = 32       # K step of the in-block loop


def matmul_kernel(x_ref, w_ref, o_ref, *, nk: int):
    """One (BM, BN) output tile; ``x_ref`` holds its (BM, K) rows and
    ``w_ref`` its (K, BN) columns."""
    def body(i, acc):
        x = x_ref[:, pl.ds(i * BK, BK)]
        w = w_ref[pl.ds(i * BK, BK), :]
        return acc + pl.dot(x, w)

    acc = jax.lax.fori_loop(0, nk, body, jnp.zeros((BM, BN), jnp.float32))
    o_ref[...] = acc.astype(o_ref.dtype)


def matmul(x: jax.Array, w: jax.Array) -> jax.Array:
    """(M, K) @ (K, N) with M, N multiples of 64 and K a power of two that
    is a multiple of 32."""
    m, k = x.shape
    _, n = w.shape
    assert m % BM == 0 and n % BN == 0 and k % BK == 0, (x.shape, w.shape)
    return pl.pallas_call(
        functools.partial(matmul_kernel, nk=k // BK),
        grid=(m // BM, n // BN),
        in_specs=[pl.BlockSpec((BM, k), lambda i, j: (i, 0)),
                  pl.BlockSpec((k, BN), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((BM, BN), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=jax.default_backend() == "cpu",
    )(x, w)


if __name__ == "__main__":
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((256, 512)) * 0.1, jnp.float32)
    w = jnp.asarray(rng.standard_normal((512, 128)) * 0.1, jnp.float32)
    got = np.asarray(matmul(x, w))
    want = np.asarray(x, np.float64) @ np.asarray(w, np.float64)
    diff = np.abs(got - want).max()
    # fp32 operands may run as TF32 on the tensor cores (a 10-bit
    # mantissa): outputs here are ~0.2, so TF32 rounding stays near 1e-4,
    # under the 1e-3 bar; the interpreter's true fp32 lands far below it.
    print(f"minimal pallas matmul ({jax.default_backend()}): "
          f"max|diff| = {diff:.2e} -> {'PASSED' if diff < 1e-3 else 'FAILED'}")
    assert diff < 1e-3
