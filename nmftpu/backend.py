"""Which implementation runs on which platform.

This is the one place the library decides it. A hand-written kernel runs
only on a platform it is compiled for and where it beat the plain
`jax.numpy` form that XLA compiles, measured on the card at the
benchmark's shapes (PERF.md, Findings). Everywhere else the plain form
runs. Interpret mode is never chosen here: a caller that wants a kernel
in the Pallas interpreter (the CPU tests) passes ``interpret=True``.

An unknown platform is an error, not a silent fallback.
"""

from __future__ import annotations

import os

import jax

# JAX's names for the platforms the library has made its choices on
_PLATFORMS = {"cpu": "cpu", "gpu": "gpu", "cuda": "gpu"}

# kernel -> platforms where its compiled form is the implementation
_KERNELS = {
    "mips_reservoir": frozenset({"gpu"}),
}

# the compile cache's directory where JAX_COMPILATION_CACHE_DIR is unset:
# fixed, inside the checkout (listed in .gitignore)
_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache",
)

# share of the device's memory one resident structure may take, and the
# fixed budget of a device that reports no memory statistics (the CPU)
_BUDGET_SHARE = 0.5
_FIXED_BUDGET = 8 * 1024**3


def platform(name: str | None = None) -> str:
    """The library's name for `name` (default: JAX's default backend);
    raises for a platform the library has made no choice for."""
    name = jax.default_backend() if name is None else name
    try:
        return _PLATFORMS[name]
    except KeyError:
        raise RuntimeError(
            f"nmftpu has no implementation choice for platform {name!r}; "
            f"known platforms: {sorted(set(_PLATFORMS.values()))}"
        ) from None


def use_kernel(kernel: str, name: str | None = None) -> bool:
    """True when `kernel`'s compiled form runs on the platform."""
    return platform(name) in _KERNELS[kernel]


def memory_budget(env: str) -> int:
    """Bytes one device-resident structure (a densified V, the iALS
    per-row Grams, a minibatch V) may take: the `env` override if set,
    else half of the default device's `bytes_limit`, else 8 GiB."""
    if env in os.environ:
        return int(os.environ[env])
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit * _BUDGET_SHARE) if limit else _FIXED_BUDGET


def use_compile_cache() -> str:
    """Turn on JAX's persistent compile cache for an entry script and
    return its directory: JAX_COMPILATION_CACHE_DIR where set (JAX reads
    the variable itself; nothing else is set), else `.jax_cache` at the
    root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    return _CACHE_DIR
