"""Test harness: force an 8-device CPU mesh before JAX initializes.

HGAPREC_TEST_TPU=1 keeps the real TPU backend instead, for the
hardware-marked suites (test_pallas_tail_hw.py) that must execute
compiled Mosaic kernels; everything else skips itself on TPU or runs
fine either way.
"""

import os

_USE_TPU = os.environ.get("HGAPREC_TEST_TPU") == "1"

# Force CPU with 8 virtual devices: the shell env pins JAX_PLATFORMS to the
# TPU plugin, and TPU default precision would perturb the f32 golden
# comparisons. NOTE: JAX snapshots JAX_PLATFORMS at import time, so the env
# var must be overridden through jax.config, not os.environ.
if not _USE_TPU:
    os.environ["JAX_PLATFORMS"] = "cpu"   # for any subprocesses
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not _USE_TPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(os.path.dirname(__file__), "..", ".jax_cache"))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
# the XLA AOT sub-caches embed host CPU features and warn loudly when the
# sandbox migrates; the jit cache alone gives the speedup we need
jax.config.update("jax_persistent_cache_enable_xla_caches", "none")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs the port's CUDA kernels)")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_synthetic(rng, n=40, m=30, k=3, density=0.3, max_count=5,
                   binary=False, rating_threshold=1):
    """Small synthetic ratings store + validation/test maps."""
    from hgaprec_tpu.data.ratings import RatingsStore

    store = RatingsStore(n, m, binary=binary,
                         rating_threshold=rating_threshold)
    mask = rng.random((n, m)) < density
    counts = rng.integers(1, max_count + 1, size=(n, m))
    u, i = np.nonzero(mask)
    y = counts[u, i]
    # hold out ~20% test, ~5% validation
    r = rng.random(u.size)
    tr = r < 0.75
    va = (r >= 0.75) & (r < 0.8)
    te = r >= 0.8
    store.add_training(u[tr] + 1, i[tr] + 1, y[tr])  # external ids offset
    store.finalize()
    validation = {}
    test = {}
    for a, b, c in zip(u[va], i[va], y[va]):
        un = store.user2seq.get(a + 1)
        mn = store.movie2seq.get(b + 1)
        if un is not None and mn is not None:
            validation[(un, mn)] = int(c)
    for a, b, c in zip(u[te], i[te], y[te]):
        un = store.user2seq.get(a + 1)
        mn = store.movie2seq.get(b + 1)
        if un is not None and mn is not None:
            test[(un, mn)] = int(c)
    return store, validation, test


@pytest.fixture
def synthetic(rng):
    return make_synthetic(rng)
