"""Test configuration.

Unless ``JAX_PLATFORMS`` names another platform, force JAX onto a virtual
8-device CPU platform *before* jax is imported, so multi-device sharding
paths are exercised on a single host (the analog of the reference's
single-process test strategy, SURVEY.md §4). Tests marked ``gpu`` check
what only the GPU compiler decides; they skip unless the default backend
is a GPU (``chip_smoke.py`` runs them on the card with
``JAX_PLATFORMS=cuda``).
"""

import os

_platforms = os.environ.get("JAX_PLATFORMS", "")
PIN_CPU = _platforms in ("", "cpu")
if PIN_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if PIN_CPU:
    # A plugin registered by the environment could otherwise win; the
    # config update (post-import, pre-backend-init) reliably pins to CPU.
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX's default backend is
    not a GPU (decided here at run time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU backend, default is {dev.platform!r}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def small_file(tmp_path, rng):
    """Canonical fixture: 3×4 f32 L2 space (mirrors the reference's
    ``create_test_mvf`` fixture, ``src/tests/test_utils.rs:52-76``)."""
    from metrovector_tpu import Builder

    data = np.array(
        [[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0], [9.0, 10.0, 11.0, 12.0]],
        dtype=np.float32,
    )
    b = Builder()
    b.add_vector_space("embeddings", dim=4)
    b.add_vectors("embeddings", data)
    path = tmp_path / "small.mvt"
    b.build().save(path)
    return path, data
