"""The persistent compile cache every entry point enables, and the
one-process-per-card rule of the benchmark scripts."""

import os
import re

import jax
import pytest

from vit_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_POINTS = ["bench.py", "chip_smoke.py", "__graft_entry__.py",
                "vit_tpu/bench/serving.py", "vit_tpu/bench/model.py",
                "tools/attention_routes.py"]


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def _read(rel):
    with open(os.path.join(ROOT, rel)) as f:
        return f.read()


def test_env_dir_is_used_and_nothing_else_set(monkeypatch,
                                              restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_checkouts_jax_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_default_dir_is_gitignored():
    lines = _read(".gitignore").split()
    assert ".jax_cache/" in lines or ".jax_cache" in lines


@pytest.mark.parametrize("rel", ENTRY_POINTS)
def test_entry_points_use_the_helper(rel):
    src = _read(rel)
    assert "enable_compile_cache()" in src
    # No other cache location anywhere: no home directory, no temp dir.
    assert "jax_compilation_cache_dir" not in src
    assert ".jax_cache" not in src and "mkdtemp" not in src


@pytest.mark.parametrize("rel", ENTRY_POINTS)
def test_no_second_jax_process(rel):
    # One process per card: no entry point starts another Python.
    src = _read(rel)
    assert not re.search(r"sys\.executable|subprocess\.(run|Popen)\(\s*\[?"
                         r"\s*['\"]python", src)
