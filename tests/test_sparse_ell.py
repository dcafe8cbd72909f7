"""Gather-only ELL engine tests vs. the dense oracle."""

import numpy as np
import pytest

from nmftpu import sparse as hs
from nmftpu import sparse_ell as se
from nmftpu.linalg import dense as D


def _sprandom(rng, n=45, m=37, density=0.25, powerlaw=False):
    if powerlaw:
        from nmftpu.data import synthetic_powerlaw_sparse
        sp = synthetic_powerlaw_sparse(n, m, nnz=n * m // 3, seed=1)
        return sp.todense(), sp
    dense = rng.uniform(0.2, 2.0, (n, m))
    mask = rng.uniform(size=(n, m)) < density
    mask[:, 0] = True
    mask[0, :] = True
    dense = (dense * mask).astype(np.float32)
    return dense, hs.from_dense(dense)


def _factors(rng, n, m, r):
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    return W, H


@pytest.mark.parametrize("powerlaw", [False, True])
@pytest.mark.parametrize("seg_max", [8, 512])
def test_v_ht_and_wt_v_match_dense(rng, powerlaw, seg_max):
    dense, sp = _sprandom(rng, powerlaw=powerlaw)
    n, m = dense.shape
    W, H = _factors(rng, n, m, 5)
    pair = se.build_ell_pair(sp, seg_max=seg_max,
                             buckets=(8, 32, 128, 512))
    np.testing.assert_allclose(
        np.asarray(se.v_ht_ell(pair.rows, H, chunk=16)), dense @ H.T,
        rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(se.wt_v_ell(pair, W, chunk=16)), W.T @ dense,
        rtol=1e-4, atol=1e-4,
    )


def test_sddmm_ell_matches_dense(rng):
    dense, sp = _sprandom(rng)
    n, m = dense.shape
    W, H = _factors(rng, n, m, 4)
    ell = se.build_ell_rows(sp, seg_max=16, buckets=(8, 16))
    s = se.sddmm_ell(ell, W, H, chunk=8)
    WH = W @ H
    for orig_b, samp_b in zip(ell.buckets, s.buckets):
        vals = np.asarray(orig_b.vals)
        got = np.asarray(samp_b.vals)
        rows = np.asarray(orig_b.out_row)
        cols = np.asarray(orig_b.cols)
        nz = vals != 0
        want = WH[np.repeat(rows[:, None], orig_b.width, 1)[nz], cols[nz]]
        np.testing.assert_allclose(got[nz], want, rtol=1e-4)


def test_mu_frobenius_ell_matches_dense(rng):
    dense, sp = _sprandom(rng)
    n, m = dense.shape
    W, H = _factors(rng, n, m, 4)
    pair = se.build_ell_pair(sp, seg_max=32, buckets=(8, 32))
    We, He = se.mu_update_frobenius_ell(pair, W, H)
    Wd, Hd = D.mu_update_frobenius(dense, W, H)
    np.testing.assert_allclose(np.asarray(We), np.asarray(Wd), rtol=3e-4)
    np.testing.assert_allclose(np.asarray(He), np.asarray(Hd), rtol=3e-4)


def test_mu_kl_ell_descends_sparse_objective(rng):
    dense, sp = _sprandom(rng)
    n, m = dense.shape
    W, H = _factors(rng, n, m, 4)
    pair = se.build_ell_pair(sp, seg_max=32, buckets=(8, 32))
    from nmftpu import sparse_ops as so
    coo = so.device_put_sparse(sp, chunk=256)
    prev = float(so.kl_error(coo, W, H))
    for _ in range(10):
        W, H = se.mu_update_kl_ell(pair, W, H)
        W, H = np.asarray(W), np.asarray(H)
        cur = float(so.kl_error(coo, W, H))
        assert cur <= prev * (1 + 1e-4)
        prev = cur


def test_long_rows_split_into_segments(rng):
    """A row with more nonzeros than seg_max must split and still sum."""
    n, m = 6, 200
    dense = np.zeros((n, m), np.float32)
    dense[2, :] = rng.uniform(0.5, 1.0, m)  # 200 nnz in one row
    dense[0, 0] = 1.0
    sp = hs.from_dense(dense)
    ell = se.build_ell_rows(sp, seg_max=64, buckets=(8, 64))
    total_segments = sum(
        int(np.sum(np.asarray(b.vals).any(axis=1))) for b in ell.buckets
    )
    assert total_segments >= 4  # 200/64 -> 4 segments for row 2
    H = rng.uniform(0.1, 1.0, (3, m)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(se.v_ht_ell(ell, H)), dense @ H.T, rtol=1e-4
    )


def test_compute_sparse_ell_strategy(rng):
    from nmftpu import NmfConfig, Initialization, Objective
    from nmftpu.sparse_ops import compute_sparse

    dense, sp = _sprandom(rng)
    n, m = dense.shape
    W0, H0 = _factors(rng, n, m, 4)
    cfg = NmfConfig(
        rank=4, init_method=Initialization.COPY_EXISTING,
        num_iterations=15, check_interval=5,
    )
    re_ = compute_sparse(sp, cfg, W0=W0, H0=H0, strategy="ell")
    rs = compute_sparse(sp, cfg, W0=W0, H0=H0, strategy="scatter")
    np.testing.assert_allclose(
        re_.frobenius_error, rs.frobenius_error, rtol=1e-3
    )
    # KL too
    cfg_kl = NmfConfig(
        rank=4, objective=Objective.KL,
        init_method=Initialization.COPY_EXISTING,
        num_iterations=10, check_interval=5,
    )
    rk = compute_sparse(sp, cfg_kl, W0=W0, H0=H0, strategy="ell")
    rk2 = compute_sparse(sp, cfg_kl, W0=W0, H0=H0, strategy="scatter")
    np.testing.assert_allclose(rk.kl_error, rk2.kl_error, rtol=1e-3)


@pytest.mark.parametrize("alg_name", ["als", "acls", "ahcls", "gdcls",
                                      "nsnmf"])
def test_ell_strategy_other_algorithms(rng, alg_name):
    from nmftpu import Algorithm, NmfConfig, Initialization
    from nmftpu.sparse_ops import compute_sparse

    dense, sp = _sprandom(rng)
    n, m = dense.shape
    W0, H0 = _factors(rng, n, m, 4)
    cfg = NmfConfig(
        rank=4, algorithm=Algorithm(alg_name),
        init_method=Initialization.COPY_EXISTING,
        num_iterations=10, check_interval=5,
        lambda_w=0.05, lambda_h=0.05, lambda_tik=0.05, theta=0.3,
    )
    re_ = compute_sparse(sp, cfg, W0=W0, H0=H0, strategy="ell")
    rs = compute_sparse(sp, cfg, W0=W0, H0=H0, strategy="scatter")
    np.testing.assert_allclose(
        re_.frobenius_error, rs.frobenius_error, rtol=1e-3
    )
