"""Test-suite environment: the CPU backend with 8 virtual devices.

The tests run on the CPU (``JAX_PLATFORMS=cpu``) with eight virtual devices
for the mesh tests. Tests of code that runs only on the card carry the
``gpu`` marker and skip without one; whether a card is present is decided
inside the ``gpu`` fixture, never while a module is imported (every xdist
worker must collect the same tests).
"""

import os

import jax

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

#: Tests measured >=~4 s on a 1-CPU container. Every subsystem these cover
#: also has fast tests that stay in the default profile; the slow ones are
#: the full-size / golden / mesh variants. Regenerate with `pytest -q
#: --durations=0` and update this set.
SLOW_TESTS = {
    "test_int8_tp_forward_matches_single_device",
    "test_mesh_multibucket_single_dispatch",
    "test_params_from_safetensors_matches_torch_path",
    "test_bench_serving_tiny",
    "test_bf16_forward_close_to_fp32_oracle",
    "test_classify_example_offline",
    "test_dp_forward_matches_single_device",
    "test_forward_quant_golden_b16",
    "test_golden_end_to_end",
    "test_graft_entry_multichip",
    "test_quant_accuracy_report_flip_rate_and_smoothquant_win",
    "test_sharded_orbax_roundtrip",
    "test_smooth_params_is_float_identity_and_helps_int8",
    "test_tp_forward_matches_single_device",
    "test_train_state_checkpoint_on_mesh",
    "test_train_state_resume_is_deterministic",
    "test_train_step_on_mesh",
    "test_train_tiny_example_converges",
    "test_variant_forward_xla",
    "test_vit_b16_full_size_parity",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (tests marked ``gpu``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
