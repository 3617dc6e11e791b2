"""Multi-device execution (mesh + shardings).

The reference has no distributed layer at all (SURVEY.md §2.6: single GPU,
hardcoded 'cuda:0'). This package expresses "scale throughput" as a device
mesh with XLA GSPMD shardings — batch data-parallelism over the 'data' axis
and Megatron-style tensor-parallelism over the 'model' axis — with all
collectives inserted by XLA (NCCL over NVLink on a multi-GPU host).
"""

from vit_tpu.parallel.mesh import batch_sharding, make_mesh, param_shardings

__all__ = ["make_mesh", "param_shardings", "batch_sharding"]
