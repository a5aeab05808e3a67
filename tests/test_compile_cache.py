"""The persistent compile cache goes where JAX_COMPILATION_CACHE_DIR says
(JAX reads it itself, nothing is set in code), else to <repo>/.jax_cache."""
import os

import jax
import pytest

from seeksv_tpu.utils.compile_cache import REPO_CACHE, configure_compile_cache


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_wins_and_nothing_is_set(monkeypatch, tmp_path,
                                         restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_repo_dir_when_env_unset(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert configure_compile_cache() == REPO_CACHE
    assert jax.config.jax_compilation_cache_dir == REPO_CACHE
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert REPO_CACHE == os.path.join(repo, ".jax_cache")
