"""int8 storage of V: `quantize_v`'s error bound and exactness on the
rating grid it is built for."""

import numpy as np

from nmftpu.linalg import dense as D


def test_quantize_v_roundtrip_error_bound(rng):
    V = rng.uniform(0.0, 5.0, (50, 40)).astype(np.float32)
    Vq, scale = D.quantize_v(V)
    recon = np.asarray(Vq, np.float32) * float(scale)
    assert np.max(np.abs(recon - V)) <= float(scale) / 2 + 1e-6


def test_quantize_exact_on_rating_grid():
    """Half-star ratings with max 6.35 quantize exactly (scale = .05)."""
    V = (np.arange(128).reshape(8, 16) % 13) * 0.5
    V[0, 0] = 6.35
    Vq, scale = D.quantize_v(V.astype(np.float32))
    recon = np.asarray(Vq, np.float32) * float(scale)
    np.testing.assert_allclose(recon, V, atol=1e-6)
