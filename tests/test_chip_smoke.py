"""chip_smoke.py: its refusal without a GPU, and each phase run here on a
tiny configuration (the card runs them at full width)."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as C
import np_oracle as O
from vit_tpu.config import ViTConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ViTConfig(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
                 num_layers=2, mlp_dim=128)


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_gpu():
    out = _run_script(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "needs a GPU" in out.stderr


def test_fails_alone_in_an_empty_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_script(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_main_returns_nonzero_on_cpu(capsys):
    assert C.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_check_fails_on_nan_and_over_tolerance():
    C._check("fine", 1e-4, 1e-3)
    with pytest.raises(AssertionError):
        C._check("nan", float("nan"), 1e-3)
    with pytest.raises(AssertionError):
        C._check("large", 2e-3, 1e-3)


def _tiny_fixture(cfg, weights_seed=3, pixels_seed=4, mid=1):
    from vit_tpu.weights.synthetic import golden_pixels

    params = C.golden_params(cfg, weights_seed)
    px = golden_pixels(cfg, seed=pixels_seed)
    final, hiddens = O.forward_with_hiddens(params, px, cfg)
    return {"weights_seed": np.int32(weights_seed),
            "pixels_seed": np.int32(pixels_seed), "mid_layer": np.int32(mid),
            "final_hidden": final.astype(np.float32),
            "mid_hidden": hiddens[mid].astype(np.float32)}


def test_phase_golden_tiny():
    C.phase_golden(_tiny_fixture(TINY), TINY)


def test_phase_golden_detects_a_mismatch():
    fx = _tiny_fixture(TINY)
    fx["mid_hidden"] = fx["mid_hidden"] + 0.01
    with pytest.raises(AssertionError):
        C.phase_golden(fx, TINY)


def test_phase_serving_tiny():
    params = C.golden_params(TINY, 5)
    C.phase_serving(TINY, params, buckets=(1, 2, 4), sizes=(1, 3, 4, 5))


def test_phase_attention_small():
    C.phase_attention(batch=1, shapes=((13, 2, 8), (20, 2, 16)))


def test_phase_int8_tiny():
    C.phase_int8(TINY, C.golden_params(TINY, 6), batch=2)


def test_phase_training_tiny():
    C.phase_training(TINY.replace(dtype=jnp.bfloat16, num_classes=10),
                     batch=2, steps=2)


def test_phase_variants_tiny():
    C.phase_variants({"tiny": TINY,
                      "tiny-deit": TINY.replace(num_prefix_tokens=2),
                      "tiny-cls": TINY.replace(pooling="cls")}, batch=1)


def test_phase_multi_on_virtual_devices():
    assert len(jax.devices()) >= 4
    C.phase_multi(TINY.replace(dtype=jnp.bfloat16), batch=8, train_batch=4)
