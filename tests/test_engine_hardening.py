"""Regressions for the round-2 core-engine review: padded-RMSD on the
dense mesh, low-precision scatter accumulation, f64 routing, config
validation, plan revalidation, cached timed-callback state."""

import dataclasses

import jax
import numpy as np
import pytest

from nmftpu import Algorithm, Initialization, NmfConfig, Objective
from nmftpu import sparse as hs
from nmftpu.driver import compute
from nmftpu.sparse_ops import (
    compute_sparse,
    device_put_sparse,
    prepare_sparse,
    v_ht,
    wt_v,
)


def _lowrank(rng, n, m, r, dtype=np.float32):
    W = rng.uniform(0.1, 1.0, (n, r)).astype(dtype)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(dtype)
    return (W @ H).astype(dtype)


def test_dense_mesh_rmsd_uses_true_numel(rng):
    """Zero-padding V to the mesh shape must not shrink the in-loop RMSD
    (pad elements contribute zero error but used to inflate the
    denominator, firing RMSD thresholds early)."""
    from nmftpu.parallel import make_grid_mesh

    n, m = 30, 26  # 2x4 mesh -> padded to 32x28 (n*m grows 1.15x)
    V = _lowrank(rng, n, m, 3)
    stats = []

    def cb(run, it, err, delta):
        stats.append(float(err))

    cfg = NmfConfig(rank=3, num_iterations=20, check_interval=5,
                    threshold_type="rmsd", seed=1,
                    init_method=Initialization.COPY_EXISTING)
    W0 = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (3, m)).astype(np.float32)
    compute(V, cfg, W0=W0, H0=H0, mesh=make_grid_mesh((2, 4)),
            callback=cb)
    ref_stats = []

    def cb2(run, it, err, delta):
        ref_stats.append(float(err))

    compute(V, cfg, W0=W0, H0=H0, callback=cb2)
    np.testing.assert_allclose(stats, ref_stats, rtol=1e-4)


def test_scatter_spmm_accumulates_above_bf16(rng):
    """bf16 factors: the scatter-add must accumulate at f32 — thousands
    of contributions per column vanish below a bf16 running sum's ulp."""
    n, m, r = 4096, 4, 2
    dense = np.full((n, m), 0.25, np.float32)
    coo = device_put_sparse(hs.from_dense(dense), chunk=1024)
    import jax.numpy as jnp

    W = jnp.ones((n, r), jnp.bfloat16) * 0.25
    got = np.asarray(wt_v(coo, W), np.float32)
    # each output entry is sum of 4096 * (0.25*0.25): exact = 256
    np.testing.assert_allclose(got, 256.0, rtol=1e-2)
    H = jnp.ones((r, m), jnp.bfloat16) * 0.25
    got = np.asarray(v_ht(coo, H), np.float32)
    np.testing.assert_allclose(got, 0.25 * 0.25 * m, rtol=1e-2)


def test_float64_auto_routes_to_scatter(rng):
    """auto strategy must not silently downgrade an f64 request to the
    bf16 densified engine."""
    dense = _lowrank(rng, 20, 16, 2, np.float64)
    dense[dense < np.quantile(dense, 0.4)] = 0.0
    dense[:, 0] += 0.5
    dense[0, :] += 0.5
    plan = prepare_sparse(hs.from_dense(dense),
                          NmfConfig(rank=2, dtype="float64"))
    assert plan.strategy == "scatter"


def test_ell_float64_is_exact(rng):
    """ELL primitives accumulate at the table dtype: under x64 the
    gather-engine SpMM is f64-exact (used to truncate to f32)."""
    from nmftpu import sparse_ell as SE
    import jax.numpy as jnp

    dense = _lowrank(rng, 30, 26, 3, np.float64)
    dense[dense < np.quantile(dense, 0.5)] = 0.0
    ellpair = SE.build_ell_pair(hs.from_dense(dense), dtype=jnp.float64)
    H = rng.uniform(0.1, 1.0, (3, 26))
    out = np.asarray(SE.v_ht_ell(ellpair.rows, H))
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, dense @ H.T, rtol=1e-13)


def test_alpha_confidence_requires_mu_or_als_frobenius():
    with pytest.raises(ValueError, match="alpha_confidence"):
        NmfConfig(rank=3, algorithm=Algorithm.ACLS, alpha_confidence=1.0)
    with pytest.raises(ValueError, match="alpha_confidence"):
        NmfConfig(rank=3, objective=Objective.KL, alpha_confidence=1.0)
    NmfConfig(rank=3, alpha_confidence=1.0)  # weighted MU
    NmfConfig(rank=3, algorithm=Algorithm.ALS,
              alpha_confidence=1.0)  # iALS


def test_plan_run_revalidates_v_storage(rng):
    dense = _lowrank(rng, 24, 20, 3)
    dense[dense < np.quantile(dense, 0.5)] = 0.0
    dense[:, 0] += 0.5
    dense[0, :] += 0.5
    cfg = NmfConfig(rank=3, num_iterations=3)
    plan = prepare_sparse(hs.from_dense(dense), cfg, strategy="ell")
    with pytest.raises(ValueError, match="v_storage"):
        plan.run(config=dataclasses.replace(cfg, v_storage="int8"))


def test_prepare_sparse_rejects_mismatched_devicecoo(rng):
    import jax.numpy as jnp

    dense = _lowrank(rng, 24, 20, 3)
    coo = device_put_sparse(hs.from_dense(dense), dtype=jnp.float32)
    with pytest.raises(ValueError, match="DeviceCOO"):
        prepare_sparse(coo, NmfConfig(rank=3, dtype="bfloat16"))


def test_densified_tail_panel_matches_padded(rng):
    """Blocked densified KL with n NOT a multiple of block_rows (the
    dense-registry route) matches the same computation at a dividing
    block size — the tail panel runs the same math."""
    from nmftpu.densified import mu_update_kl_densified
    import jax.numpy as jnp

    n, m, r = 90, 40, 4  # 90 % 32 = 26-tail
    Vd = jnp.asarray(_lowrank(rng, n, m, r), jnp.bfloat16)
    W = jnp.asarray(rng.uniform(0.1, 1.0, (n, r)), jnp.float32)
    H = jnp.asarray(rng.uniform(0.1, 1.0, (r, m)), jnp.float32)
    W1, H1 = mu_update_kl_densified(Vd, W, H, block_rows=32)
    W2, H2 = mu_update_kl_densified(Vd, W, H, block_rows=45)  # divides
    np.testing.assert_allclose(np.asarray(W1), np.asarray(W2),
                               rtol=2e-2, atol=1e-4)


def test_verbosity3_elapsed_resets_across_invocations(rng, capsys):
    """The timed verbosity-3 callback lives in the cached runner; a
    second driver call must restart its clock, not report minutes."""
    V = _lowrank(rng, 20, 16, 2)
    cfg = NmfConfig(rank=2, num_iterations=10, check_interval=5,
                    verbosity=3)
    compute(V, cfg)
    import time

    time.sleep(1.2)
    capsys.readouterr()
    compute(V, cfg)
    out = capsys.readouterr().out
    first = [ln for ln in out.splitlines() if "iter      5" in ln]
    assert first, out
    ms = float(first[0].split("elapsed")[1].split("ms")[0])
    assert ms < 1000.0, f"stale t0 leaked across invocations: {ms} ms"


def test_config_coerces_enum_strings(rng):
    """These are str-enums: a raw string compares EQUAL but fails the
    `is` dispatch — NmfConfig(objective='kullback-leibler') used to run
    Frobenius silently."""
    cfg = NmfConfig(rank=3, objective="kullback-leibler", algorithm="mu",
                    init_method="all_random_values", threshold_type="rmsd")
    assert cfg.objective is Objective.KL
    assert cfg.algorithm is Algorithm.MU
    assert cfg.init_method is Initialization.ALL_RANDOM_VALUES
    V = _lowrank(rng, 20, 16, 3) + 0.1
    res = compute(V, dataclasses.replace(cfg, num_iterations=5))
    assert res.kl_error is not None and np.isfinite(res.kl_error)
    with pytest.raises(ValueError):
        NmfConfig(rank=3, objective="not-an-objective")


def test_nmf_warns_on_ignored_warm_start(rng):
    import nmftpu

    V = _lowrank(rng, 12, 10, 2)
    W0 = rng.uniform(0.1, 1.0, (12, 2)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (2, 10)).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="warm start"):
        nmftpu.nmf(V, 2, W0=W0, H0=H0, num_iterations=3)


def test_mesh_unknown_strategy_rejected(rng):
    import nmftpu
    from nmftpu.parallel import make_grid_mesh

    dense = _lowrank(rng, 16, 16, 2)
    dense[dense < np.quantile(dense, 0.5)] = 0.0
    dense[:, 0] += 0.5
    dense[0, :] += 0.5
    with pytest.raises(ValueError, match="strategy"):
        nmftpu.nmf(hs.from_dense(dense), 2, num_iterations=3,
                   mesh=make_grid_mesh((2, 4)), strategy="scater")


def test_sharded_ell_out_rows_sorted(rng):
    """Every tile's padded out_row must stay non-decreasing — the ELL
    scatter-adds promise indices_are_sorted=True to XLA."""
    from nmftpu.parallel.sharded_ell import partition_sparse_ell

    # skewed rows so tiles have very different segment counts
    n, m = 60, 64
    dense = np.zeros((n, m), np.float32)
    dense[:8, :] = rng.uniform(0.5, 1.0, (8, m))  # heavy rows
    dense[8:, ::16] = 1.0                         # sparse tail
    sp = hs.from_dense(dense)
    op, row_perm, col_perm = partition_sparse_ell(
        sp, (2, 4), balance=False, seg_max=8, buckets=(2, 4, 8)
    )
    for ra in op.r_rows + op.c_rows:
        a = np.asarray(ra)
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                assert (np.diff(a[i, j]) >= 0).all(), (i, j, a[i, j])
