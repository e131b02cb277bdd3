"""Persistent compilation cache placement (utils/compile_cache.py)."""

from pathlib import Path

from ltx_jax.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_wins_and_code_sets_nothing(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_is_a_fixed_directory_in_the_checkout(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    second = compile_cache.enable_compile_cache()
    assert first == second == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2


def test_default_directory_is_git_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
    assert compile_cache.DEFAULT_DIR.parent == REPO
