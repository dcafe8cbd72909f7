"""mu_style='jacobi': simultaneous MU half-steps.

Jacobi coupling computes both half-steps from the incoming (W, H) —
identical fixed points to Gauss–Seidel (both stationarity conditions
read numer == denom at the same pair), different trajectory. It exists
as the enabler for single-V-read fused numerator kernels; the engine
keeps gauss-seidel as the default.
"""

import numpy as np
import pytest

from nmftpu import NmfConfig, nmf
from nmftpu.driver import compute
from nmftpu.linalg import dense as D


def _data(rng, n=64, m=48, r=5):
    Wt = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    Ht = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    return Wt @ Ht + 0.01 * rng.uniform(size=(n, m)).astype(np.float32)


def test_jacobi_objective_decreases_and_tracks_gs(rng):
    V = _data(rng)
    rng2 = np.random.default_rng(1)
    W0 = rng2.uniform(0.1, 1.0, (64, 5)).astype(np.float32)
    H0 = rng2.uniform(0.1, 1.0, (5, 48)).astype(np.float32)

    def err(W, H):
        return float(np.linalg.norm(V - np.asarray(W) @ np.asarray(H)))

    Wj, Hj = W0, H0
    Wg, Hg = W0, H0
    errs_j = [err(Wj, Hj)]
    for _ in range(120):
        Wj, Hj = D.mu_update_frobenius(V, Wj, Hj, order="jacobi")
        Wg, Hg = D.mu_update_frobenius(V, Wg, Hg, order="WH")
        errs_j.append(err(Wj, Hj))
    # trajectory: overall decrease (jacobi has no per-half-step monotone
    # guarantee; require decrease over the run and near-monotone tail)
    assert errs_j[-1] < errs_j[0] * 0.5
    assert errs_j[-1] <= min(errs_j[:-1]) * 1.01
    # comparable converged quality at equal iteration count
    assert errs_j[-1] <= err(Wg, Hg) * 1.10
    assert (np.asarray(Wj) >= 0).all() and (np.asarray(Hj) >= 0).all()


def test_jacobi_shares_gs_fixed_points(rng):
    V = _data(rng, n=40, m=30, r=4)
    res = compute(V, NmfConfig(rank=4, num_iterations=400, seed=0))
    W, H = np.asarray(res.W), np.asarray(res.H)
    W2, H2 = D.mu_update_frobenius(V, W, H, order="jacobi")
    # at a (near-)stationary GS point one jacobi step moves ~nothing
    assert float(np.max(np.abs(np.asarray(W2) - W))) < 1e-2 * W.max()
    assert float(np.max(np.abs(np.asarray(H2) - H))) < 1e-2 * H.max()


@pytest.mark.parametrize("objective", ["frobenius", "kullback-leibler"])
def test_jacobi_through_public_api(rng, objective):
    V = _data(rng)
    res = nmf(V, 5, objective=objective, num_iterations=60, seed=0,
              mu_style="jacobi")
    ref = nmf(V, 5, objective=objective, num_iterations=60, seed=0)
    assert np.isfinite(res.frobenius_error)
    metric = ("frobenius_error" if objective == "frobenius"
              else "kl_error")
    assert getattr(res, metric) <= getattr(ref, metric) * 1.15


@pytest.mark.parametrize("v_storage", ["bfloat16", "int8"])
def test_jacobi_low_precision_storage(rng, v_storage):
    V = _data(rng)
    res = nmf(V, 5, num_iterations=40, seed=0, mu_style="jacobi",
              v_storage=v_storage)
    ref = nmf(V, 5, num_iterations=40, seed=0, v_storage=v_storage)
    assert np.isfinite(res.frobenius_error)
    assert res.frobenius_error <= ref.frobenius_error * 1.15


def test_jacobi_rejections(rng):
    V = _data(rng)
    with pytest.raises(ValueError, match="MU algorithm only"):
        NmfConfig(rank=4, algorithm="als", mu_style="jacobi")
    with pytest.raises(ValueError, match="gauss-seidel' or 'jacobi"):
        NmfConfig(rank=4, mu_style="bogus")
    with pytest.raises(ValueError, match="Frobenius and KL"):
        NmfConfig(rank=4, objective="beta-divergence", beta=1.5,
                  mu_style="jacobi")
    from nmftpu.sparse import from_dense
    from nmftpu.sparse_ops import compute_sparse

    with pytest.raises(ValueError, match="dense engine only"):
        compute_sparse(from_dense(V), NmfConfig(rank=4,
                                                mu_style="jacobi"))
    from nmftpu.parallel import compute_sharded, make_grid_mesh

    with pytest.raises(ValueError, match="dense engine only"):
        compute_sharded(from_dense(V),
                        NmfConfig(rank=4, mu_style="jacobi"),
                        mesh=make_grid_mesh((2, 4)))
