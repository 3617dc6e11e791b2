"""vit_tpu — a Vision Transformer inference and training stack in JAX/XLA.

Built from scratch in JAX with the capabilities of the reference
``cmeraki/vit.triton`` (a Triton-kernel ViT for CUDA GPUs; see SURVEY.md);
it runs on an NVIDIA GPU (and on the CPU for tests):

- :mod:`vit_tpu.ops`      — the op library (the reference's ``vit/kernels/``
  tier: layernorm, softmax, linear matmul with bias/GELU, patching, patch
  embedding) plus the fused attention the reference only planned
  (reference README.md:27), routed to cuDNN on the GPU.
- :mod:`vit_tpu.models`   — the ViT forward graph as a single jit-compiled
  functional program (the reference's torch ``vit/vit.py`` module tree).
- :mod:`vit_tpu.weights`  — HuggingFace ``ViTModel`` weight import with
  coverage + zero-scan verification (reference ``vit/load_weights.py``,
  ``vit/utils.py:45-113``).
- :mod:`vit_tpu.parallel` — mesh/sharding entry points (batch-DP + TP);
  the reference is single-GPU-only.
- :mod:`vit_tpu.utils`    — tracing/timing harnesses (reference
  ``vit/utils.py``: ``tensor_info``, ``timed``, ``benchmark``) and the
  persistent compile cache every entry point enables.
- :mod:`vit_tpu.bench`    — end-to-end benchmark harness emitting the
  reference's ``benchmarks/<name>/Performance.csv`` artifacts.
- :mod:`vit_tpu.train`    — jitted AdamW train step (XLA autodiff); DP/TP
  sharding from the inputs' shardings.
- :mod:`vit_tpu.serving`  — bucketed fixed-shape serving (compile-once
  replay), one device or mesh fan-out.
- :mod:`vit_tpu.quant`    — int8 quantized inference tier (docs/QUANT.md).
"""

from vit_tpu.config import ViTConfig, VARIANTS

__version__ = "0.6.0"

__all__ = ["ViTConfig", "VARIANTS", "__version__"]
