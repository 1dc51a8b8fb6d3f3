"""Persistent compilation cache wiring (utils.compile_cache): a second
process compiling an identical search program loads the serialized
executable from disk instead. The directory is $JAX_COMPILATION_CACHE_DIR
when set, else <checkout>/.jax_cache."""

import os

import jax
import numpy as np
import pytest

from metrovector_tpu.utils import enable_compilation_cache
from metrovector_tpu.utils.compile_cache import (
    CHECKOUT_CACHE_DIR,
    compilation_cache_dir,
)


@pytest.fixture(autouse=True)
def _restore_cache_config():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
    # reset the once-per-process cache singleton too, so later tests don't
    # keep writing into this test's (deleted) tmp directory
    from jax.experimental.compilation_cache import compilation_cache as cc

    cc.reset_cache()


def test_cache_populates_and_search_kernel_is_cached(tmp_path, rng,
                                                     monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    got = enable_compilation_cache()
    assert got == str(tmp_path / "cache")
    assert jax.config.jax_compilation_cache_dir == got

    from metrovector_tpu import Builder, Reader, SearchEngine

    # Shapes unique to this test: under the full suite the in-process jit
    # cache already holds common (n, d, k, batch) search executables, and a
    # cache hit never writes a persistent entry — a fresh compile must be
    # forced for the on-disk cache to populate.
    data = rng.standard_normal((307, 72)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=72)
    b.add_vectors("v", data)
    path = tmp_path / "c.mvt"
    b.build().save(path)
    eng = SearchEngine(Reader.open(path).vector_space("v"))
    eng.search(rng.standard_normal((3, 72)).astype(np.float32), k=9)
    entries = os.listdir(got)
    assert entries, "search compile produced no persistent cache entries"


@pytest.mark.parametrize("env", ["set", "unset", "empty"])
def test_cache_placement(tmp_path, monkeypatch, env):
    """$JAX_COMPILATION_CACHE_DIR wins when set (and no other directory is
    configured); otherwise the cache lands in <checkout>/.jax_cache."""
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
        want = str(tmp_path / "e")
    else:
        if env == "unset":
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
        want = CHECKOUT_CACHE_DIR
    assert compilation_cache_dir() == want
    got = enable_compilation_cache()
    assert got == want and os.path.isdir(got)
    assert jax.config.jax_compilation_cache_dir == want


def test_checkout_cache_dir_is_repo_root_and_ignored():
    import metrovector_tpu

    root = os.path.dirname(os.path.dirname(metrovector_tpu.__file__))
    assert CHECKOUT_CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
