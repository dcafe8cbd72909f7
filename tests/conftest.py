"""Test harness: an 8-virtual-device CPU platform, set BEFORE jax imports
(SURVEY.md §4.3 — every sharded code path must pass on this mesh).

The tests run on the CPU unless JAX_PLATFORMS names another platform:
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` runs the tests marked
`gpu` on the card (the `gpu_device` fixture skips them elsewhere)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
# Double precision is a first-class citizen of the reference (float/double
# dispatch, SURVEY.md C2); enable x64 so float64 configs are exact in tests.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The card, for tests marked `gpu`; skips where JAX has none. The
    decision is made here, per test, so every worker collects the same
    tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


def make_lowrank(rng, n, m, r, noise=0.01, dtype=np.float32):
    """Nonnegative matrix with an exact rank-r nonnegative structure + noise."""
    W = rng.uniform(0.1, 1.0, size=(n, r)).astype(dtype)
    H = rng.uniform(0.1, 1.0, size=(r, m)).astype(dtype)
    V = W @ H + noise * rng.uniform(0.0, 1.0, size=(n, m)).astype(dtype)
    return V.astype(dtype)


@pytest.fixture
def lowrank():
    return make_lowrank


# Single-process full-suite mitigation (ON by default): ~500+ distinct
# XLA CPU programs accumulated in one process reproducibly crash the
# compiler near the end of the suite (SIGSEGV/SIGABRT in
# backend_compile_and_load; each test innocent in isolation — judged
# round 4). Dropping the jit caches every N tests bounds the live
# compiled-program set and the full suite completes in one process
# (measured: 549 tests in 622 s at N=40, FASTER than the 3-shard
# runner — shared fixtures recompile less than three interpreters
# cost). scripts/run_tests.py remains the belt-and-braces sharded
# gate. Set NMFTPU_CLEAR_CACHES_EVERY=0 to disable.
_CLEAR_EVERY = int(os.environ.get("NMFTPU_CLEAR_CACHES_EVERY", "40"))
_test_counter = [0]


@pytest.fixture(autouse=_CLEAR_EVERY > 0)
def _periodic_cache_clear():
    yield
    _test_counter[0] += 1
    if _CLEAR_EVERY and _test_counter[0] % _CLEAR_EVERY == 0:
        jax.clear_caches()
