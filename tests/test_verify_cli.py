"""The vit_tpu.verify CLI (notebook-02 equivalent) end to end."""

import pytest

from vit_tpu.verify import main

SMALL_ARGS = ["--hidden", "48", "--layers", "2", "--heads", "4",
              "--intermediate", "96", "--image", "32", "--patch", "16"]


def test_verify_passes_on_random_oracle(capsys):
    rc = main(SMALL_ARGS)
    out = capsys.readouterr().out
    assert rc == 0
    assert "PASSED" in out
    assert "encoder.layer.1" in out  # per-layer rows printed


def test_verify_ones_mode(capsys):
    rc = main(SMALL_ARGS + ["--ones"])
    assert rc == 0
    assert "PASSED" in capsys.readouterr().out


def test_verify_unfused_attention(capsys):
    # The oracle is HF's eager (unfused) attention; another seed and batch.
    rc = main(SMALL_ARGS + ["--batch", "3", "--seed", "4"])
    assert rc == 0
    assert "PASSED" in capsys.readouterr().out


def test_verify_fails_on_impossible_tol(capsys):
    rc = main(SMALL_ARGS + ["--tol", "1e-12"])
    assert rc == 1
    assert "FAILED" in capsys.readouterr().out
