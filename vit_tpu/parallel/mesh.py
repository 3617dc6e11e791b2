"""Device mesh + GSPMD sharding rules for the ViT graph.

Design (scaling-book recipe: pick a mesh, annotate shardings, let XLA insert
collectives):

- Mesh axes ``('data', 'model')``. Inference serving typically uses pure DP
  (``model=1``); TP is available for large variants (H/14) or latency-bound
  serving.
- Tensor-parallel layout is the standard Megatron split, expressed purely as
  ``NamedSharding`` annotations — XLA inserts the (reduce-scatter/all-reduce)
  collectives:

  * QKV kernel  (L, D, 3D): output-column sharded -> heads split across
    'model' (requires 3D % model == 0 and num_heads % model == 0).
  * attn out    (L, D, D):  input-row sharded (row-parallel) -> psum.
  * fc1         (L, D, M):  output-column sharded.
  * fc2         (L, M, D):  input-row sharded -> psum.
  * layernorms, embeddings, cls/pos: replicated.

- Activations: batch axis sharded over 'data' everywhere; the per-device
  program is the single-device one on its shard.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vit_tpu.config import ViTConfig
from vit_tpu.models.vit import Params


def make_mesh(data: int = 1, model: int = 1,
              devices: list | None = None) -> Mesh:
    """Build a ('data', 'model') mesh from the first data*model devices."""
    devices = devices if devices is not None else jax.devices()
    n = data * model
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def param_shardings(params: Params, mesh: Mesh, cfg: ViTConfig) -> Params:
    """NamedSharding pytree matching ``params`` (Megatron TP over 'model').

    Works for the float pytree AND the int8 tier's
    (:func:`vit_tpu.quant.quantize_params`): a quantized ``kernel`` is
    ``{"q": int8 (L,K,N), "scale": fp32 (L,N)}`` — ``q`` takes the float
    kernel's split, and the per-OUTPUT-channel scale follows the output
    dim: sharded with the columns for column-parallel kernels (qkv, fc1),
    replicated for row-parallel ones (out, fc2) whose outputs are summed
    across shards.
    """
    model = mesh.shape["model"]
    if model > 1:
        assert cfg.num_heads % model == 0, (cfg.num_heads, model)
        assert cfg.mlp_dim % model == 0, (cfg.mlp_dim, model)

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    rules = {
        # (leading layer axis, in-dim, out-dim) for stacked encoder kernels.
        "qkv": {"kernel": ns(None, None, "model"), "bias": ns(None, "model")},
        "out": {"kernel": ns(None, "model", None), "bias": ns(None, None)},
        "fc1": {"kernel": ns(None, None, "model"), "bias": ns(None, "model")},
        "fc2": {"kernel": ns(None, "model", None), "bias": ns(None, None)},
        "ln1": {"scale": ns(None, None), "bias": ns(None, None)},
        "ln2": {"scale": ns(None, None), "bias": ns(None, None)},
    }
    # Per-output-channel quant scales (L, N): split iff the output dim is.
    scale_rules = {"qkv": ns(None, "model"), "fc1": ns(None, "model"),
                   "out": ns(None, None), "fc2": ns(None, None)}

    def kernel_rule(name, leaf):
        if isinstance(leaf, dict):  # int8: {"q": ..., "scale": ...}
            return {"q": rules[name]["kernel"], "scale": scale_rules[name]}
        return rules[name]["kernel"]

    shardings: Params = {
        "embeddings": jax.tree.map(lambda _: ns(), params["embeddings"]),
        "encoder": {k: {kk: (kernel_rule(k, params["encoder"][k][kk])
                             if kk == "kernel" else rules[k][kk])
                        for kk in params["encoder"][k]}
                    for k in params["encoder"]},
        "ln_final": jax.tree.map(lambda _: ns(), params["ln_final"]),
    }
    if "classifier" in params:
        shardings["classifier"] = jax.tree.map(lambda _: ns(),
                                               params["classifier"])
    return shardings


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Activations/batch: leading axis over 'data', rest replicated."""
    return NamedSharding(mesh, P("data"))
