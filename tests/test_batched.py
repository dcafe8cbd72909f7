"""Batched multi-problem NMF: one vmapped program == B separate runs."""

import numpy as np
import pytest

from nmftpu import Algorithm, NmfConfig
from nmftpu.batched import compute_batched
from nmftpu.driver import compute


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def _stack(rng, B=5, n=24, m=18):
    return np.abs(rng.normal(size=(B, n, m))).astype(np.float32) + 0.05


@pytest.mark.parametrize("alg,obj", [
    ("mu", "frobenius"),
    ("mu", "kullback-leibler"),
    ("hals", "frobenius"),
    ("als", "frobenius"),
])
def test_batched_matches_per_problem(rng, alg, obj):
    """Every slab's factors equal an independent compute() call with
    the problem's own folded seed."""
    Vs = _stack(rng)
    cfg = NmfConfig(rank=3, algorithm=alg, objective=obj,
                    num_iterations=8, check_interval=4, seed=7)
    res = compute_batched(Vs, cfg)
    assert res.W.shape == (5, 24, 3) and res.H.shape == (5, 3, 18)
    import jax

    root = jax.random.PRNGKey(7)
    for i in range(5):
        # per-problem oracle: same init key (fold_in by problem index)
        from nmftpu.init import initialize_factors

        key = jax.random.fold_in(root, i)
        W0, H0 = initialize_factors(Vs[i], 3, cfg.init_method, key)
        cfg_i = NmfConfig(rank=3, algorithm=alg, objective=obj,
                          num_iterations=8, check_interval=4, seed=7,
                          init_method="copy_existing")
        ri = compute(Vs[i], cfg_i, W0=np.asarray(W0), H0=np.asarray(H0))
        np.testing.assert_allclose(np.asarray(res.W[i]),
                                   np.asarray(ri.W), rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res.frobenius_error[i],
                                   ri.frobenius_error, rtol=2e-5)
        assert res.num_iterations[i] == ri.num_iterations
    d = res[2]
    assert np.isfinite(d["error"]) and d["W"].shape == (24, 3)
    assert len(res) == 5


def test_batched_copy_existing_and_stats(rng):
    Vs = _stack(rng, B=3)
    W0 = np.abs(rng.normal(size=(3, 24, 4))).astype(np.float32)
    H0 = np.abs(rng.normal(size=(3, 4, 18))).astype(np.float32)
    cfg = NmfConfig(rank=4, num_iterations=6, check_interval=2,
                    init_method="copy_existing")
    res = compute_batched(Vs, cfg, W0=W0, H0=H0)
    # stats recorded per problem at every check
    assert len(res.stats) == 3
    assert res.stats[0].iterations.tolist() == [2.0, 4.0, 6.0]
    assert (res.stats[1].errors > 0).all()
    # errors differ across problems (distinct data, distinct fits)
    assert len(set(np.round(res.frobenius_error, 5))) == 3


def test_batched_guards(rng):
    Vs = _stack(rng, B=2)
    with pytest.raises(ValueError, match="num_runs"):
        compute_batched(Vs, NmfConfig(rank=3, num_runs=2,
                                      num_iterations=2))
    with pytest.raises(ValueError, match="fixed iteration"):
        compute_batched(Vs, NmfConfig(rank=3, threshold_value=0.1,
                                      num_iterations=2))
    with pytest.raises(ValueError, match="verbosity"):
        compute_batched(Vs, NmfConfig(rank=3, verbosity=2,
                                      num_iterations=2))
    with pytest.raises(ValueError, match="B, n, m"):
        compute_batched(Vs[0], NmfConfig(rank=3, num_iterations=2))


def test_batched_kl_and_nndsvda(rng):
    """KL objective reports per-problem divergences; NNDSVD init takes
    the host path per problem."""
    Vs = _stack(rng, B=3)
    cfg = NmfConfig(rank=3, objective="kullback-leibler",
                    num_iterations=6, check_interval=3,
                    init_method="nndsvda")
    res = compute_batched(Vs, cfg)
    assert res.kl_error is not None and (res.kl_error > 0).all()
    # deterministic init -> rerun is identical
    res2 = compute_batched(Vs, cfg)
    np.testing.assert_array_equal(np.asarray(res.W),
                                  np.asarray(res2.W))


def test_batched_runner_is_cached(rng):
    """Repeated calls reuse the compiled vmapped runner (review
    finding: a fresh jit per call recompiled every time)."""
    import time

    Vs = _stack(rng, B=3)
    cfg = NmfConfig(rank=3, num_iterations=5, check_interval=5)
    compute_batched(Vs, cfg)  # compile
    t0 = time.perf_counter()
    for _ in range(3):
        compute_batched(Vs, cfg)
    warm = (time.perf_counter() - t0) / 3
    t0 = time.perf_counter()
    compute_batched(Vs, cfg)
    assert warm < 0.15  # cached dispatch, not a recompile

    # and the stats contract matches the solo driver
    res = compute_batched(Vs, cfg)
    assert res.stats[0].iterations.dtype == np.int64


def test_batched_problem0_equals_plain_solo(rng):
    """Problem 0's folded key coincides with the solo driver's first
    restart, so it is bit-equal to a naive compute() call."""
    Vs = _stack(rng, B=2)
    cfg = NmfConfig(rank=3, num_iterations=6, check_interval=3, seed=9)
    res = compute_batched(Vs, cfg)
    solo = compute(Vs[0], cfg)
    np.testing.assert_array_equal(np.asarray(res.W[0]),
                                  np.asarray(solo.W))
