"""The platform decision (nmftpu.backend): which implementation runs
where, the device-memory budgets and the compile-cache rule."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nmftpu import backend
from nmftpu.kernels import mips_reservoir as M


@pytest.mark.parametrize("name,expect", [
    ("cpu", False), ("gpu", True), ("cuda", True),
])
def test_kernel_choice_by_platform(name, expect):
    assert backend.use_kernel("mips_reservoir", name) is expect


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
def test_unknown_platform_is_an_error(name):
    with pytest.raises(RuntimeError, match="no implementation choice"):
        backend.use_kernel("mips_reservoir", name)


def test_default_platform_here_is_cpu():
    assert backend.platform() == "cpu"
    assert not backend.use_kernel("mips_reservoir")


def _spy(monkeypatch, name):
    calls = []
    real = getattr(M, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(M, name, wrapped)
    return calls


@pytest.mark.parametrize("interpret,expect", [
    (False, "_scan_plain"), (True, "_scan_kernel"),
])
def test_interpret_mode_only_on_request(monkeypatch, rng, interpret,
                                        expect):
    """On the CPU the plain scan runs; the kernel runs (in the Pallas
    interpreter) only when the caller asks for interpret mode."""
    plain = _spy(monkeypatch, "_scan_plain")
    kern = _spy(monkeypatch, "_scan_kernel")
    Wq = jnp.asarray(rng.standard_normal((5, 16)).astype(np.float32))
    H = jnp.asarray(rng.standard_normal((16, 200)).astype(np.float32))
    # a fresh k per case: the jitted entry point traces again
    k = 3 if interpret else 4
    M.reservoir_topk_mips(Wq, H, k, slots=32, q_block=16,
                          interpret=interpret)
    assert (plain + kern) == [expect]


def test_gpu_platform_routes_fitting_shapes_to_kernel(monkeypatch):
    """With the platform reported as a GPU the entry point picks the
    kernel for power-of-two rank and slots, and the plain scan for
    shapes the Triton kernel does not take."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.use_kernel("mips_reservoir")
    assert M.kernel_fits(256, 4096) and M.kernel_fits(16, 16)
    assert not M.kernel_fits(100, 4096)
    assert not M.kernel_fits(256, 1000)
    assert not M.kernel_fits(8, 4096)


def test_memory_budget_env_override(monkeypatch):
    monkeypatch.setenv("NMFTPU_DENSIFY_BUDGET_BYTES", "12345")
    assert backend.memory_budget("NMFTPU_DENSIFY_BUDGET_BYTES") == 12345


def test_memory_budget_without_memory_stats(monkeypatch):
    monkeypatch.delenv("NMFTPU_DENSIFY_BUDGET_BYTES", raising=False)
    assert backend.memory_budget("NMFTPU_DENSIFY_BUDGET_BYTES") \
        == 8 * 1024**3


def test_memory_budget_from_bytes_limit(monkeypatch):
    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 60 * 1024**3}

    monkeypatch.delenv("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    assert backend.memory_budget("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES") \
        == 30 * 1024**3


def test_densify_budget_follows_device(monkeypatch):
    """The densified strategy's choice reads the budget at call time."""
    from nmftpu.config import NmfConfig
    from nmftpu.sparse_ops import _resolve_strategy

    cfg = NmfConfig(rank=4)
    monkeypatch.setenv("NMFTPU_DENSIFY_BUDGET_BYTES", str(2 * 100 * 100))
    assert _resolve_strategy(None, cfg, "auto", 100, 100) == "densified"
    monkeypatch.setenv("NMFTPU_DENSIFY_BUDGET_BYTES", "100")
    assert _resolve_strategy(None, cfg, "auto", 100, 100) == "ell"


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = backend.use_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
