"""HALS / coordinate descent (sklearn's default 'cd' solver): cyclic
rank-1 column sweeps, bit-comparable to sklearn's _update_cdnmf_fast."""

import numpy as np
import pytest

from nmftpu import Algorithm, NmfConfig
from nmftpu import sparse as hs
from nmftpu.driver import compute
from nmftpu.sparse_ops import compute_sparse, prepare_sparse


def _problem(rng, n=40, m=30, r=5, dtype=np.float64):
    V = rng.uniform(0.1, 2.0, (n, m)).astype(dtype)
    W0 = rng.uniform(0.1, 1.0, (n, r)).astype(dtype)
    H0 = rng.uniform(0.1, 1.0, (r, m)).astype(dtype)
    return V, W0, H0


def test_hals_matches_sklearn_cd(rng):
    """Same init + same iterations + cyclic order == sklearn solver='cd'
    (shuffle=False) to float64 precision."""
    from sklearn.decomposition import NMF as SkNMF

    V, W0, H0 = _problem(rng)
    iters = 25
    sk = SkNMF(n_components=5, init="custom", solver="cd", max_iter=iters,
               tol=0.0, shuffle=False)
    W_sk = sk.fit_transform(V.copy(), W=W0.copy(), H=H0.copy())

    cfg = NmfConfig(rank=5, algorithm=Algorithm.HALS,
                    init_method="copy_existing", num_iterations=iters,
                    update_order="WH", dtype="float64", eps=0.0)
    res = compute(V, cfg, W0=W0, H0=H0)
    np.testing.assert_allclose(np.asarray(res.W), W_sk, rtol=1e-6,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.H), sk.components_,
                               rtol=1e-6, atol=1e-10)


def test_hals_converges_faster_than_mu(rng):
    """HALS's selling point: lower Frobenius error than MU at an equal
    (small) iteration budget."""
    V, W0, H0 = _problem(rng, dtype=np.float32)
    kw = dict(W0=W0.astype(np.float32), H0=H0.astype(np.float32))
    mk = lambda alg: NmfConfig(rank=5, algorithm=alg, num_iterations=10,
                               init_method="copy_existing",
                               check_interval=5)
    e_hals = compute(V, mk(Algorithm.HALS), **kw).frobenius_error
    e_mu = compute(V, mk(Algorithm.MU), **kw).frobenius_error
    assert e_hals <= e_mu * 1.001, (e_hals, e_mu)


def test_hals_sparse_and_sharded_match_dense(rng):
    from nmftpu.parallel import compute_sharded, make_grid_mesh

    V, W0, H0 = _problem(rng, dtype=np.float32)
    V[V < np.quantile(V, 0.5)] = 0.0
    V[:, 0] += 0.5
    V[0, :] += 0.5
    cfg = NmfConfig(rank=5, algorithm=Algorithm.HALS, num_iterations=8,
                    init_method="copy_existing", check_interval=4)
    kw = dict(W0=W0.astype(np.float32), H0=H0.astype(np.float32))
    rd = compute(V, cfg, **kw)
    plan = prepare_sparse(hs.from_dense(V), cfg)
    assert plan.strategy == "scatter"
    rs = compute_sparse(hs.from_dense(V), cfg, **kw)
    np.testing.assert_allclose(np.asarray(rs.W), np.asarray(rd.W),
                               rtol=1e-4, atol=1e-5)
    for engine in ("scatter", "ring"):
        rm = compute_sharded(hs.from_dense(V), cfg,
                             mesh=make_grid_mesh((2, 4)), engine=engine,
                             **kw)
        np.testing.assert_allclose(
            rm.frobenius_error, rd.frobenius_error, rtol=2e-4
        ), engine


def test_hals_sweep_impls_agree(rng):
    """The half-sweep implementations (sequential oracle, blocked XLA
    sweep at several block sizes) are the same update: exact in f64,
    roundoff-equivalent in f32; the dispatcher picks the sequential
    sweep below rank 16 and the blocked one above."""
    import jax.numpy as jnp

    from nmftpu.linalg import dense as D

    n, r = 70, 24
    XHt = rng.normal(size=(n, r)).astype(np.float64)
    A = rng.normal(size=(r, r))
    G = (A @ A.T + np.eye(r)).astype(np.float64)
    W = np.abs(rng.normal(size=(n, r))).astype(np.float64)
    Ws = np.asarray(D._hals_half_sweep(
        jnp.asarray(XHt), jnp.asarray(G), jnp.asarray(W)))
    for b in (1, 8, 16, 24):
        Wb = np.asarray(D._hals_half_sweep_blocked(
            jnp.asarray(XHt), jnp.asarray(G), jnp.asarray(W), block=b))
        np.testing.assert_allclose(Wb, Ws, rtol=1e-10, atol=1e-12)
    # f32 blocked sweep stays within roundoff of the f64 oracle
    f = np.float32
    Wb32 = np.asarray(D._hals_half_sweep_blocked(
        jnp.asarray(XHt.astype(f)), jnp.asarray(G.astype(f)),
        jnp.asarray(W.astype(f)), block=16))
    scale = np.abs(Wb32).max()
    np.testing.assert_allclose(Wb32, Ws, rtol=0, atol=1e-4 * scale)
    out = D.hals_half_sweep(jnp.asarray(XHt), jnp.asarray(G),
                            jnp.asarray(W))
    np.testing.assert_allclose(np.asarray(out), Ws, rtol=1e-10,
                               atol=1e-12)
    small = D.hals_half_sweep(jnp.asarray(XHt[:, :8]),
                              jnp.asarray(G[:8, :8]),
                              jnp.asarray(W[:, :8]))
    np.testing.assert_allclose(
        np.asarray(small),
        np.asarray(D._hals_half_sweep(jnp.asarray(XHt[:, :8]),
                                      jnp.asarray(G[:8, :8]),
                                      jnp.asarray(W[:, :8]))),
        rtol=0, atol=0)


def test_nndsvd_svds_guard(rng):
    """Sparse NNDSVD survives an svds failure on the constant start
    vector (falls back to random v0 / dense LAPACK)."""
    import scipy.sparse as sps

    from nmftpu.init.nndsvd import nndsvd_init

    # v0 = ones is orthogonal to the dominant singular subspace of this
    # matrix (columns sum to zero pattern is adversarial for ARPACK);
    # small enough that even a triple svds failure densifies fine.
    X = sps.random(60, 40, density=0.2, random_state=0,
                   data_rvs=lambda k: rng.uniform(0.1, 1.0, k))
    from nmftpu.sparse import SparseMatrix

    W, H = nndsvd_init(
        SparseMatrix.from_scipy(X) if hasattr(SparseMatrix, "from_scipy")
        else X, 5)
    assert W.shape == (60, 5) and H.shape == (5, 40)
    assert np.isfinite(W).all() and np.isfinite(H).all()


def test_hals_guards(rng):
    V, _, _ = _problem(rng, dtype=np.float32)
    with pytest.raises(ValueError, match="KL"):
        NmfConfig(rank=3, algorithm=Algorithm.HALS,
                  objective="kullback-leibler")
    with pytest.raises(ValueError, match="HALS"):
        NmfConfig(rank=3, algorithm=Algorithm.HALS, v_storage="int8")
    with pytest.raises(ValueError, match="scatter"):
        prepare_sparse(hs.from_dense(np.abs(V)),
                       NmfConfig(rank=3, algorithm="hals"),
                       strategy="ell")


def test_facade_cd_solver_matches_sklearn(rng):
    """sklearn code using the DEFAULT solver now runs unchanged."""
    from sklearn.decomposition import NMF as SkNMF

    from nmftpu.sklearn_api import NMF

    V, W0, H0 = _problem(rng)
    sk = SkNMF(n_components=5, init="custom", solver="cd", max_iter=20,
               tol=0.0)
    W_sk = sk.fit_transform(V.copy(), W=W0.copy(), H=H0.copy())
    est = NMF(n_components=5, init="custom", solver="cd", max_iter=20,
              tol=0.0, dtype="float64", eps=0.0)
    W = est.fit_transform(V, W=W0, H=H0)
    np.testing.assert_allclose(W, W_sk, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(est.components_, sk.components_,
                               rtol=1e-6, atol=1e-10)
    with pytest.raises(ValueError, match="cd"):
        NMF(n_components=3, solver="cd",
            beta_loss="kullback-leibler").fit(V)


def test_hals_transform_and_guards(rng):
    """A cd-fitted facade projects new rows with HALS (not an MU
    fallback); shuffle=True and validation ordering behave."""
    from sklearn.decomposition import NMF as SkNMF

    from nmftpu.foldin import transform
    from nmftpu.sklearn_api import NMF

    V, W0, H0 = _problem(rng)
    est = NMF(n_components=5, init="custom", max_iter=25, tol=0.0,
              dtype="float64", eps=0.0)  # default solver cd -> HALS
    est.fit(V, W=W0, H=H0)
    got = est.transform(V[:6])
    # oracle: sklearn transform on the same fitted components
    sk = SkNMF(n_components=5, init="custom", max_iter=25, tol=0.0)
    sk.fit(V.copy(), W=W0.copy(), H=H0.copy())
    want = sk.transform(V[:6])
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-6)

    # direct foldin hals == cd projection semantics
    out = transform(V[:6], est.components_, algorithm="hals",
                    num_iterations=25)
    np.testing.assert_allclose(out.W, got, rtol=1e-5, atol=1e-8)

    with pytest.raises(NotImplementedError, match="shuffle"):
        NMF(n_components=3, shuffle=True).fit(V)
    # itakura-saito is now a supported loss (solver='mu'); under the
    # default cd solver it hits sklearn's cd-is-frobenius-only rule
    with pytest.raises(ValueError, match="solver='cd'"):
        NMF(n_components=3, beta_loss="itakura-saito").fit(V)


def test_hals_regularization_matches_sklearn(rng):
    """sklearn's alpha_W/alpha_H/l1_ratio under solver='cd' map exactly
    (n_features/n_samples scaling, L2 on the Gram diagonal, L1 off the
    numerators) — factor parity with regularized sklearn CD."""
    from sklearn.decomposition import NMF as SkNMF

    from nmftpu.sklearn_api import NMF

    V, W0, H0 = _problem(rng)
    for aw, ah, l1r in ((0.002, "same", 0.0), (0.001, 0.003, 0.5),
                        (0.002, 0.0, 1.0)):
        sk = SkNMF(n_components=5, init="custom", max_iter=15, tol=0.0,
                   alpha_W=aw, alpha_H=ah, l1_ratio=l1r)
        W_sk = sk.fit_transform(V.copy(), W=W0.copy(), H=H0.copy())
        est = NMF(n_components=5, init="custom", max_iter=15, tol=0.0,
                  alpha_W=aw, alpha_H=ah, l1_ratio=l1r,
                  dtype="float64", eps=0.0)
        W = est.fit_transform(V, W=W0, H=H0)
        np.testing.assert_allclose(W, W_sk, rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(est.components_, sk.components_,
                                   rtol=1e-6, atol=1e-10)
    # still rejected where unmapped (explicit mu solver)
    with pytest.raises(NotImplementedError, match="alpha_W"):
        NMF(n_components=3, solver="mu", alpha_W=0.1).fit(V)


def test_hals_l1_engines_match(rng):
    """l1_w/l1_h penalties agree across dense / scatter / grid / ring."""
    from nmftpu.parallel import compute_sharded, make_grid_mesh

    V, W0, H0 = _problem(rng, dtype=np.float32)
    V[V < np.quantile(V, 0.5)] = 0.0
    V[:, 0] += 0.5
    V[0, :] += 0.5
    cfg = NmfConfig(rank=5, algorithm=Algorithm.HALS, num_iterations=6,
                    init_method="copy_existing", check_interval=3,
                    lambda_w=0.01, lambda_h=0.01, l1_w=0.05, l1_h=0.05)
    kw = dict(W0=W0.astype(np.float32), H0=H0.astype(np.float32))
    rd = compute(V, cfg, **kw)
    rs = compute_sparse(hs.from_dense(V), cfg, **kw)
    np.testing.assert_allclose(np.asarray(rs.W), np.asarray(rd.W),
                               rtol=1e-4, atol=1e-5)
    for engine in ("scatter", "ring"):
        rm = compute_sharded(hs.from_dense(V), cfg,
                             mesh=make_grid_mesh((2, 4)), engine=engine,
                             **kw)
        np.testing.assert_allclose(
            rm.frobenius_error, rd.frobenius_error, rtol=2e-4
        )
    with pytest.raises(ValueError, match="l1_w"):
        NmfConfig(rank=3, l1_w=0.1)  # HALS-only knob
