"""The persistent compilation cache helper (ocs2_tpu/utils/compile_cache.py)."""
import os

import jax

from ocs2_tpu.utils import compile_cache


def test_environment_variable_is_honoured(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing else.
    assert jax.config.jax_compilation_cache_dir == before


def test_fallback_is_fixed_and_inside_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == path
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(path) == root
    assert os.path.basename(path) == ".jax_cache"
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
