"""Kernels as compiled for the card, against their plain forms.

Marked `gpu`: they skip (from the `gpu_device` fixture) where JAX has no
GPU. On the card: `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`,
or `python chip_smoke.py`, which runs them in its own process.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nmftpu import backend
from nmftpu.kernels import mips_reservoir as M

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("b,r,m,slots,dtype", [
    (512, 256, 1 << 20, 4096, jnp.bfloat16),   # the serving shape's width
    (70, 64, 300_001, 1024, jnp.float32),      # odd batch, padded table
])
def test_reservoir_kernel_matches_plain_on_gpu(gpu_device, b, r, m, slots,
                                               dtype):
    key = jax.random.PRNGKey(0)
    Wq = jax.random.normal(key, (b, r), jnp.float32)
    H = jax.random.normal(jax.random.fold_in(key, 1), (r, m), dtype)
    mp = -(-m // slots) * slots
    Hp = jnp.pad(H, ((0, 0), (0, mp - m)))
    bp = -(-b // 128) * 128
    ks, ki = M._scan_kernel(jnp.pad(Wq, ((0, bp - b), (0, 0))), Hp, m,
                            slots, 128, 64, False)
    ps, pi = M._scan_plain(Wq, Hp, m, slots)
    np.testing.assert_array_equal(np.asarray(ki[:b]), np.asarray(pi))
    np.testing.assert_allclose(np.asarray(ks[:b]), np.asarray(ps),
                               rtol=1e-5, atol=1e-5)


def test_reservoir_entry_point_uses_kernel_on_gpu(gpu_device, monkeypatch):
    assert backend.use_kernel("mips_reservoir")
    calls = []
    real = M._scan_kernel
    monkeypatch.setattr(M, "_scan_kernel",
                        lambda *a: calls.append(1) or real(*a))
    key = jax.random.PRNGKey(1)
    Wq = jax.random.normal(key, (64, 128), jnp.float32)
    H = jax.random.normal(jax.random.fold_in(key, 1), (128, 50_000),
                          jnp.bfloat16)
    s, i = M.reservoir_topk_mips(Wq, H, 10, slots=512)
    assert calls
    exact = jnp.dot(Wq.astype(jnp.bfloat16), H,
                    preferred_element_type=jnp.float32)
    top = np.sort(np.asarray(jax.lax.top_k(exact, 10)[0]), axis=1)
    np.testing.assert_allclose(np.sort(np.asarray(s), axis=1), top,
                               rtol=1e-2, atol=1e-2)
