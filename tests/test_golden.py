"""Golden-fixture pin of the full import-path + forward pipeline.

The committed fixture (tests/fixtures/golden_b16.npz) holds hidden states
recorded ONCE through the real ``transformers`` torch ViTModel loaded with
our deterministic synthetic HF checkpoint (tools/record_golden.py — the
offline stand-in for the reference's real-checkpoint verification,
reference 02_verifying_layer_outputs.ipynb). This test regenerates the same
checkpoint from its seed, pushes it through the REAL import path
(safetensors file -> params_from_safetensors -> forward) and asserts <1e-3
against the recording — no torch/transformers required at test time. Any
transposition, name mis-mapping, filter-layout or numeric regression
anywhere in the pipeline breaks it.

If the real google/vit-base-patch16-224 checkpoint is available locally
(HF cache or VIT_TPU_HF_CHECKPOINT), an additional test verifies against it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_tpu.config import ViTConfig
from vit_tpu.models.vit import forward, forward_with_intermediates
from vit_tpu.weights.checkpoint import params_from_safetensors
from vit_tpu.weights.synthetic import golden_pixels, synthetic_hf_state_dict

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_b16.npz")


@pytest.fixture(scope="module")
def fixture():
    assert os.path.exists(FIXTURE), "run tools/record_golden.py"
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def golden_params(fixture, tmp_path_factory):
    from safetensors.numpy import save_file

    cfg = ViTConfig()
    sd = synthetic_hf_state_dict(cfg, seed=int(fixture["weights_seed"]))
    st = tmp_path_factory.mktemp("golden") / "synthetic_b16.safetensors"
    save_file(sd, str(st))
    return params_from_safetensors(str(st), cfg), cfg


@pytest.mark.slow
def test_golden_end_to_end(fixture, golden_params):
    params, cfg = golden_params
    px = jnp.asarray(golden_pixels(cfg, seed=int(fixture["pixels_seed"])))
    got = np.asarray(forward(params, px, cfg), np.float32)
    want = fixture["final_hidden"]
    diff = np.abs(got - want).max()
    assert diff < 1e-3, f"end-to-end max|diff| vs torch recording: {diff}"


@pytest.mark.slow
def test_golden_mid_layer(fixture, golden_params):
    params, cfg = golden_params
    px = jnp.asarray(golden_pixels(cfg, seed=int(fixture["pixels_seed"])))
    _, hiddens = forward_with_intermediates(params, px, cfg)
    mid = int(fixture["mid_layer"])
    diff = np.abs(np.asarray(hiddens[mid], np.float32)
                  - fixture["mid_hidden"]).max()
    assert diff < 1e-3, f"layer {mid} max|diff| vs torch recording: {diff}"


def _real_checkpoint() -> str | None:
    override = os.environ.get("VIT_TPU_HF_CHECKPOINT")
    if override and os.path.exists(override):
        return override
    try:
        from huggingface_hub import try_to_load_from_cache
        p = try_to_load_from_cache("google/vit-base-patch16-224",
                                   "model.safetensors")
        return p if isinstance(p, str) else None
    except Exception:
        return None


@pytest.mark.slow
@pytest.mark.skipif(_real_checkpoint() is None,
                    reason="real google/vit-base-patch16-224 checkpoint not "
                           "available offline")
def test_real_pretrained_checkpoint():
    cfg = ViTConfig()
    params = params_from_safetensors(_real_checkpoint(), cfg)
    px = jnp.asarray(golden_pixels(cfg))
    out = np.asarray(forward(params, px, cfg), np.float32)
    assert np.isfinite(out).all()
    # Real-checkpoint outputs have characteristic scale; a transposed or
    # mis-mapped load produces wildly different statistics.
    assert 0.1 < np.abs(out).mean() < 10.0
