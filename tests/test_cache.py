"""Persistent compile-cache placement (core.cache)."""

from pathlib import Path

from goicp_tpu.core import cache

REPO = Path(__file__).resolve().parents[1]


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    """Without the variable the cache sits at a fixed path inside the
    checkout, and git ignores it."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(cache.cache_dir())
    assert path == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_enable_persistent_cache_sets_no_dir_when_env_set(
    monkeypatch, tmp_path
):
    """With JAX_COMPILATION_CACHE_DIR set, enabling the cache leaves JAX's
    own directory setting alone."""
    import jax

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cache, "_enabled", False)
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.append((k, v))
    )
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in [k for k, _ in calls]
