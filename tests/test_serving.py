"""Serving layer + CLI tests."""

import json
import subprocess
import sys
import os

import numpy as np
import pytest

from nmftpu import NmfConfig
from nmftpu.driver import compute
from nmftpu.serving import Recommender
from nmftpu.sparse import from_dense


def _fit(rng, n=40, m=50, r=4):
    Wt = rng.uniform(0.0, 1.0, (n, r)) ** 2
    Ht = rng.uniform(0.0, 1.0, (r, m)) ** 2
    V = (Wt @ Ht).astype(np.float32)
    res = compute(V, NmfConfig(rank=r, num_iterations=150, seed=0))
    return V, res


def test_recommend_and_score(rng):
    V, res = _fit(rng)
    rec = Recommender(res.W, res.H)
    scores, items = rec.recommend([0, 3, 7], k=5, exclude_seen=False)
    assert scores.shape == (3, 5) and items.shape == (3, 5)
    # top-1 must match brute force on the factor product
    full = np.asarray(res.W) @ np.asarray(res.H)
    np.testing.assert_array_equal(items[:, 0],
                                  np.argmax(full[[0, 3, 7]], axis=1))
    s = rec.score(0, [1, 2, 3])
    np.testing.assert_allclose(s, full[0, [1, 2, 3]], rtol=1e-5)


def test_exclude_seen(rng):
    V, res = _fit(rng)
    train = from_dense(V)  # every item "seen"
    rec = Recommender(res.W, res.H, train=train)
    scores, _ = rec.recommend([1], k=5, exclude_seen=True)
    assert np.all(np.isneginf(scores))  # everything excluded


def test_save_load_roundtrip(tmp_path, rng):
    V, res = _fit(rng)
    rec = Recommender(res.W, res.H, train=from_dense(V))
    rec.save(str(tmp_path / "bundle"))
    rec2 = Recommender.load(str(tmp_path / "bundle"))
    s1, i1 = rec.recommend([2], k=4, exclude_seen=False)
    s2, i2 = rec2.recommend([2], k=4, exclude_seen=False)
    np.testing.assert_array_equal(i1, i2)
    assert rec2._train_csr is not None


def test_mesh_serving(rng):
    from nmftpu.parallel import make_grid_mesh

    V, res = _fit(rng, m=48)
    mesh = make_grid_mesh((2, 4))
    rec = Recommender(res.W, res.H, mesh=mesh, block=16)
    rec0 = Recommender(res.W, res.H)
    s1, i1 = rec.recommend([5], k=3, exclude_seen=False)
    s2, i2 = rec0.recommend([5], k=3, exclude_seen=False)
    np.testing.assert_array_equal(i1, i2)


@pytest.mark.slow
def test_cli_end_to_end(tmp_path, rng):
    # tiny MovieLens-format file
    lines = []
    for u in range(1, 13):
        for i in range(1, 10):
            if (u * i) % 3:
                lines.append(f"{u}\t{i}\t{(u*i) % 5 + 1}.0\t{u*100+i}")
    data = tmp_path / "u.data"
    data.write_text("\n".join(lines))

    env = dict(os.environ, NMFTPU_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    out_dir = tmp_path / "bundle"
    r = subprocess.run(
        [sys.executable, "-m", "nmftpu", str(data),
         "--rank", "3", "--iters", "30", "--eval-recall", "3",
         "--save", str(out_dir), "--verbosity", "0"],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert "frobenius_error" in summary and "recall@3" in summary
    assert (out_dir / "W.npy").exists()


def test_bf16_table_dtype(rng, tmp_path):
    """table_dtype='bfloat16' halves the item-table footprint; scores
    accumulate f32 so the top-k ordering matches f32 serving up to the
    ~0.4% storage rounding. Persistence re-applies the dtype at load."""
    from nmftpu.serving import Recommender

    n, m, r = 60, 500, 8
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    rf = Recommender(W, H, method="exact", block=128)
    rb = Recommender(W, H, method="exact", block=128,
                     table_dtype="bfloat16")
    assert str(rb.H.dtype) == "bfloat16"
    sf, i_f = rf.recommend([3, 7, 11], k=20, exclude_seen=False)
    sb, i_b = rb.recommend([3, 7, 11], k=20, exclude_seen=False)
    assert sb.dtype == np.float32
    # near-ties may swap under bf16 rounding: require high overlap and
    # close scores rather than identical order
    for a, b in zip(i_f, i_b):
        assert len(np.intersect1d(a, b)) >= 18
    np.testing.assert_allclose(sb, sf, rtol=1e-2)

    rb.save(str(tmp_path / "rec"))
    rl = Recommender.load(str(tmp_path / "rec"))
    assert rl.table_dtype == "bfloat16" and str(rl.H.dtype) == "bfloat16"
    sl, il = rl.recommend([3, 7, 11], k=20, exclude_seen=False)
    np.testing.assert_array_equal(il, i_b)

    import pytest

    with pytest.raises(ValueError):
        Recommender(W, H, table_dtype="fp8")


def test_save_load_preserves_serving_config(tmp_path, rng):
    """load() must restore method/block — a server configured for exact
    top-k must not silently come back approximate (code-review r2)."""
    W = rng.uniform(0.1, 1.0, (12, 3)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (3, 40)).astype(np.float32)
    rec = Recommender(W, H, method="exact", block=16)
    rec.save(str(tmp_path / "m"))
    loaded = Recommender.load(str(tmp_path / "m"))
    assert loaded.method == "exact" and loaded.block == 16


def test_fold_in_rejects_bad_item_ids(rng):
    W = rng.uniform(0.1, 1.0, (6, 3)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (3, 20)).astype(np.float32)
    rec = Recommender(W, H)
    with pytest.raises(ValueError, match="out of range"):
        rec.fold_in([3, 25])
    with pytest.raises(ValueError, match="out of range"):
        rec.score(0, [20])


def test_score_matches_table(rng):
    W = rng.uniform(0.1, 1.0, (4, 3)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (3, 15)).astype(np.float32)
    rec = Recommender(W, H)
    got = rec.score(2, [0, 7, 14])
    np.testing.assert_allclose(got, W[2] @ H[:, [0, 7, 14]], rtol=1e-6)


def test_fold_in_reuses_prepared_table(rng):
    """Repeated fold-ins reuse the cached table invariants (no per-call
    O(r^2 m) Gram rebuild) and stay consistent; works on a bf16 table."""
    W = rng.uniform(0.1, 1.0, (6, 4)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (4, 64)).astype(np.float32)
    rec = Recommender(W, H, table_dtype="bfloat16")
    w1 = rec.fold_in([1, 5, 9])
    prep = rec._prepared
    assert prep is not None
    w2 = rec.fold_in([1, 5, 9])
    assert rec._prepared is prep  # cached, not rebuilt
    np.testing.assert_allclose(w1, w2, rtol=1e-6)
    # against the f32 oracle: bf16 table storage rounds ~0.4%/operand
    rec32 = Recommender(W, H)
    w32 = rec32.fold_in([1, 5, 9])
    np.testing.assert_allclose(w1, w32, rtol=5e-2, atol=1e-3)


def test_batched_cold_user_serving(rng):
    """fold_in_batch / recommend_from_history_batch: one device call for
    the whole batch, per-row parity with the single-user path, per-user
    history exclusion."""
    n, m, r = 10, 40, 4
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    rec = Recommender(W, H, block=8, method="exact")

    hists = [
        np.array([1, 5, 9]),
        (np.array([2, 30]), np.array([2.0, 4.5], np.float32)),
        np.array([7]),
    ]
    Wb = rec.fold_in_batch(hists)
    assert Wb.shape == (3, r) and (Wb >= 0).all()
    for u, h in enumerate(hists):
        ids, vals = h if isinstance(h, tuple) else (h, None)
        w1 = rec.fold_in(ids, vals)
        np.testing.assert_allclose(Wb[u], w1, rtol=1e-5, atol=1e-7)

    sb, ib = rec.recommend_from_history_batch(hists, k=5)
    assert sb.shape == (3, 5)
    for u, h in enumerate(hists):
        ids = h[0] if isinstance(h, tuple) else h
        # excluded history never surfaces
        assert not set(np.asarray(ids).tolist()) & set(ib[u].tolist())
        s1, i1 = rec.recommend_from_history(
            ids, h[1] if isinstance(h, tuple) else None, k=5
        )
        np.testing.assert_array_equal(ib[u], i1)


def test_batched_fold_in_unsorted_history(rng):
    """Histories arrive in arbitrary item order; the CSR build sorts
    columns per row (the table gather and exclusion builder expect it)."""
    W = rng.uniform(0.1, 1.0, (6, 3)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (3, 25)).astype(np.float32)
    rec = Recommender(W, H, block=8)
    a = rec.fold_in(np.array([20, 3, 11]), np.array([1.0, 2.0, 3.0]))
    b = rec.fold_in(np.array([3, 11, 20]), np.array([2.0, 3.0, 1.0]))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_int8_table_dtype(rng, tmp_path):
    """table_dtype='int8': quarter-footprint item table, order-stable
    scoring (one symmetric scale folded into the f32 scores), fold-in
    through the scaled PreparedTable, save/load round-trip."""
    n, m, r = 12, 200, 6
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    ref = Recommender(W, H, block=64, method="exact")
    q = Recommender(W, H, block=64, method="exact", table_dtype="int8")
    assert np.asarray(q.H).dtype == np.int8

    s_ref, i_ref = ref.recommend(np.arange(n), k=10)
    s_q, i_q = q.recommend(np.arange(n), k=10)
    # per-entry quantization <= 0.4% of max: near-total top-10 overlap
    overlap = np.mean([
        len(set(i_ref[u].tolist()) & set(i_q[u].tolist())) / 10
        for u in range(n)
    ])
    assert overlap >= 0.9, overlap
    np.testing.assert_allclose(s_q, s_ref, rtol=3e-2, atol=1e-2)

    # scores and fold-in match the f32 table closely
    np.testing.assert_allclose(
        q.score(3, [0, 5, 99]), ref.score(3, [0, 5, 99]),
        rtol=2e-2, atol=1e-2,
    )
    hist = np.array([4, 80, 150])
    np.testing.assert_allclose(
        q.fold_in(hist), ref.fold_in(hist), rtol=5e-2, atol=1e-2
    )
    # weighted fold-in exercises the scaled per-user Grams
    np.testing.assert_allclose(
        q.fold_in(hist, alpha_confidence=4.0),
        ref.fold_in(hist, alpha_confidence=4.0), rtol=5e-2, atol=1e-2,
    )

    q.save(str(tmp_path / "q"))
    q2 = Recommender.load(str(tmp_path / "q"))
    assert q2.table_dtype == "int8"
    # per-dimension scales: true H = diag(scale) @ Hq
    np.testing.assert_allclose(
        np.asarray(q2.H).astype(np.float32)
        * np.asarray(q2._h_scale)[:, None],
        np.asarray(q.H).astype(np.float32)
        * np.asarray(q._h_scale)[:, None],
        rtol=1e-2, atol=1e-2,
    )


def test_int8_table_sharded(rng):
    from nmftpu.parallel import make_grid_mesh

    n, m, r = 8, 160, 4
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    ref = Recommender(W, H, block=32, method="exact")
    q = Recommender(W, H, block=32, method="exact", table_dtype="int8",
                    mesh=make_grid_mesh((2, 4)))
    s_ref, i_ref = ref.recommend(np.arange(n), k=8)
    s_q, i_q = q.recommend(np.arange(n), k=8)
    overlap = np.mean([
        len(set(i_ref[u].tolist()) & set(i_q[u].tolist())) / 8
        for u in range(n)
    ])
    assert overlap >= 0.9, overlap


def test_history_batch_edge_cases(rng):
    """Generators are materialized once (exclusion still applies), tuple
    id-lists are rejected loudly, empty batches return (0, r)."""
    W = rng.uniform(0.1, 1.0, (6, 3)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (3, 30)).astype(np.float32)
    rec = Recommender(W, H, block=8, method="exact")
    hists = [np.array([1, 9]), np.array([4])]

    sb, ib = rec.recommend_from_history_batch(
        (h for h in hists), k=5  # generator input
    )
    assert not {1, 9} & set(ib[0].tolist())
    assert 4 not in ib[1].tolist()

    with pytest.raises(ValueError, match="tuple history"):
        rec.fold_in_batch([(3, 7)])  # plain tuple of ids, ambiguous

    We = rec.fold_in_batch([])
    assert We.shape == (0, 3)


def test_score_scale_consistency(rng):
    """h_scale must accompany an integer table and only an integer
    table."""
    from nmftpu.retrieval import topk_mips_blocked

    W = rng.uniform(0.1, 1.0, (2, 3)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (3, 16)).astype(np.float32)
    Hq = np.round(H / 0.01).astype(np.int8)
    with pytest.raises(ValueError, match="h_scale"):
        topk_mips_blocked(W, H, k=3, block=8, h_scale=0.5)
    with pytest.raises(ValueError, match="scale"):
        topk_mips_blocked(W, Hq, k=3, block=8)
    s, i = topk_mips_blocked(W, Hq, k=3, block=8, h_scale=0.01)
    assert np.isfinite(np.asarray(s)).all()


def test_config_dtype_aliases(rng):
    """dtype aliases normalize so string-compared rules can't be
    bypassed (e.g. the f64 engine routing with 'double')."""
    from nmftpu import NmfConfig
    from nmftpu.sparse_ops import _resolve_strategy

    cfg = NmfConfig(rank=2, dtype="f4")
    assert cfg.dtype == "float32"
    cfg = NmfConfig(rank=2, dtype="double")
    assert cfg.dtype == "float64"
    assert _resolve_strategy(None, cfg, "auto", 8, 8) == "scatter"


def test_oversampling_exclusion_matches_scatter(rng):
    """Single-device exclusion dispatch: with narrow seen lists the
    Recommender routes through topk_mips_excluded (oversampled
    candidates, no per-block scatter — the megablock serving path) and
    must agree with the scatter-list form exactly; wide seen lists fall
    back to the lists form."""
    V, res = _fit(rng, n=30, m=400, r=4)
    seen_mask = rng.random((30, 400)) < 0.05
    train = from_dense(np.where(seen_mask, V, 0.0))
    rec = Recommender(res.W, res.H, train=train, method="exact")
    assert rec.block == 400  # clamped to the catalog, not 1<<20
    uids = [0, 5, 9]
    seen = rec._seen_padded(rec._train_csr, np.asarray(uids), k=7)
    assert seen is not None  # narrow lists -> oversampling path
    s1, i1 = rec.recommend(uids, k=7, exclude_seen=True)
    # force the scatter-lists form for the same query
    s2, i2 = rec._topk(rec.W[uids], 7, rec._exclusion(np.asarray(uids)),
                       None)
    np.testing.assert_allclose(s1, np.asarray(s2), rtol=1e-6)
    for r_ in range(3):
        assert set(i1[r_].tolist()) == set(np.asarray(i2)[r_].tolist())
    # no seen item surfaces
    csr = rec._train_csr
    for r_, u in enumerate(uids):
        su = set(csr.indices[csr.indptr[u]:csr.indptr[u + 1]].tolist())
        assert not (su & set(i1[r_].tolist()))
    # wide seen lists (k + S > block) -> dispatch returns None
    assert rec._seen_padded(rec._train_csr, np.asarray(uids),
                            k=399) is None


def test_recommend_certified(rng):
    """Recommender.recommend_certified: certified rows equal the exact
    recommend() results; sharded Recommenders reject."""
    V, res = _fit(rng, n=30, m=600, r=4)
    seen_mask = rng.random((30, 600)) < 0.03
    train = from_dense(np.where(seen_mask, V, 0.0))
    rec = Recommender(res.W, res.H, train=train, method="exact")
    s_ex, i_ex = rec.recommend([0, 4, 8], k=9)
    s, i, cert = rec.recommend_certified([0, 4, 8], k=9,
                                         candidate_k=64)
    assert cert.shape == (3,)
    for row in range(3):
        if cert[row]:
            np.testing.assert_allclose(s[row], s_ex[row], rtol=1e-6)
            assert set(i[row].tolist()) == set(i_ex[row].tolist())
    assert cert.all()  # generous candidate budget certifies everything

    from nmftpu.parallel import make_grid_mesh

    # round 5: the sharded path certifies too (per-shard compare-reduce
    # counts psum'd over the items axis) and must agree with the
    # single-device certificate on the same data
    rec_m = Recommender(res.W, res.H, train=train,
                        mesh=make_grid_mesh((2, 4)), block=75)
    s_m, i_m, cert_m = rec_m.recommend_certified([0, 4, 8], k=9,
                                                 candidate_k=64)
    assert cert_m.all()
    for row in range(3):
        assert set(i_m[row].tolist()) == set(i_ex[row].tolist())


# -- reservoir serving (fused Pallas kernel; interpret mode on CPU) --------


def test_reservoir_method_end_to_end(rng):
    """method='reservoir' with slots >= m is the exact top-k (each item
    owns a slot); m=50 is NOT a slots multiple, so this also covers the
    construction-time table padding (pad columns must never surface)."""
    V, res = _fit(rng)
    rec = Recommender(res.W, res.H, method="reservoir",
                      reservoir_slots=128)
    assert rec.n_items == 50 and rec.H.shape[1] == 128  # padded table
    s, i = rec.recommend([0, 3, 7], k=5, exclude_seen=False)
    full = np.asarray(res.W) @ np.asarray(res.H)
    expect = np.argsort(-full[[0, 3, 7]], axis=1)[:, :5]
    assert (i < 50).all()
    # bf16 kernel scoring: compare sets via true scores (ties possible)
    for q in range(3):
        np.testing.assert_allclose(
            np.sort(full[[0, 3, 7]][q, i[q]]),
            np.sort(full[[0, 3, 7]][q, expect[q]]), rtol=2e-2, atol=1e-3)


def test_reservoir_seen_exclusion(rng):
    V, res = _fit(rng, m=40)
    # each user has seen their top-2 items
    full = np.asarray(res.W) @ np.asarray(res.H)
    seen_dense = np.zeros_like(V)
    top2 = np.argsort(-full, axis=1)[:, :2]
    for u in range(V.shape[0]):
        seen_dense[u, top2[u]] = 1.0
    rec = Recommender(res.W, res.H, train=from_dense(seen_dense),
                      method="reservoir", reservoir_slots=128)
    s, i = rec.recommend([1, 2], k=5, exclude_seen=True)
    for row, u in enumerate([1, 2]):
        assert not (set(i[row].tolist()) & set(top2[u].tolist()))


def test_reservoir_save_load_strips_padding(tmp_path, rng):
    V, res = _fit(rng, m=50)
    rec = Recommender(res.W, res.H, train=from_dense(V),
                      method="reservoir", reservoir_slots=128)
    rec.save(str(tmp_path / "bundle"))
    H_saved = np.load(str(tmp_path / "bundle" / "H.npy"))
    assert H_saved.shape[1] == 50  # padding stripped on save
    rec2 = Recommender.load(str(tmp_path / "bundle"))
    assert rec2.method == "reservoir" and rec2.reservoir_slots == 128
    s1, i1 = rec.recommend([2], k=4, exclude_seen=False)
    s2, i2 = rec2.recommend([2], k=4, exclude_seen=False)
    np.testing.assert_array_equal(i1, i2)


def test_reservoir_rejects_bad_method(rng):
    V, res = _fit(rng)
    with pytest.raises(ValueError, match="approx|exact|reservoir"):
        Recommender(res.W, res.H, method="bogus")


def test_reservoir_sharded_matches_single_device(rng):
    """method='reservoir' on an items-sharded mesh: each shard runs the
    fused scan over its local slice (slots >= m_loc here, so exact),
    the cross-shard merge is exact, and seen exclusion rides the
    oversampled drop after the merge."""
    from nmftpu.parallel import make_grid_mesh

    V, res = _fit(rng, m=64)
    full = np.asarray(res.W) @ np.asarray(res.H)
    top2 = np.argsort(-full, axis=1)[:, :2]
    seen_dense = np.zeros_like(V)
    for u in range(V.shape[0]):
        seen_dense[u, top2[u]] = 1.0
    mesh = make_grid_mesh((2, 4))
    rec_m = Recommender(res.W, res.H, train=from_dense(seen_dense),
                        mesh=mesh, method="reservoir",
                        reservoir_slots=128)
    rec_1 = Recommender(res.W, res.H, train=from_dense(seen_dense),
                        method="exact", block=16)
    users = [0, 3, 9, 17]
    s_m, i_m = rec_m.recommend(users, k=5)
    s_1, i_1 = rec_1.recommend(users, k=5)
    for row in range(len(users)):
        assert set(i_m[row].tolist()) == set(i_1[row].tolist()), row
        assert not (set(i_m[row].tolist())
                    & set(top2[users[row]].tolist()))

    # mask/lists exclusion forms are rejected on the sharded reservoir
    from nmftpu.parallel import topk_mips_sharded

    with pytest.raises(ValueError, match="reservoir"):
        topk_mips_sharded(
            res.W[:4], rec_m.H, 5, mesh=mesh, method="reservoir",
            exclude_mask=np.zeros((4, 64), bool))


def test_int8_per_dim_scales_on_skewed_table(rng):
    """NMF factor rows span orders of magnitude; per-dimension int8
    scales must preserve ranking where a single per-table scale would
    crush the quiet dimensions to +-1 levels."""
    n, m, r = 12, 400, 6
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    row_mag = 10.0 ** np.arange(r - 1, -1, -1, dtype=np.float32)  # 1e5..1
    # queries weight the QUIET dims so ranking hinges on them
    W = W / row_mag[None, :]
    H = H * row_mag[:, None]
    ref = Recommender(W, H)
    q = Recommender(W, H, table_dtype="int8")
    assert np.asarray(q._h_scale).shape == (r,)
    s_ref, i_ref = ref.recommend(np.arange(n), k=10, exclude_seen=False)
    s_q, i_q = q.recommend(np.arange(n), k=10, exclude_seen=False)
    overlap = np.mean([
        len(set(i_ref[u].tolist()) & set(i_q[u].tolist())) / 10
        for u in range(n)])
    assert overlap >= 0.9, overlap
    # a GLOBAL scale on this table zeroes the three quietest rows
    g = np.abs(H).max() / 127.0
    assert (np.round(H[-3:] / g) == 0).all()

    # the reservoir path folds the vector scale into the query side
    rq = Recommender(W, H, table_dtype="int8", method="reservoir",
                     reservoir_slots=512)
    s_r, i_r = rq.recommend(np.arange(n), k=10, exclude_seen=False)
    overlap_r = np.mean([
        len(set(i_ref[u].tolist()) & set(i_r[u].tolist())) / 10
        for u in range(n)])
    assert overlap_r >= 0.9, overlap_r


def test_reservoir_certified(rng):
    """Certified serving over reservoir candidates: with slots >= m the
    reservoir is exact, so every row certifies; with a tiny reservoir
    (slots=8 over m=300) forced misses must yield certified=False, never
    a wrong row labeled exact."""
    V, res = _fit(rng, m=300)
    rec = Recommender(res.W, res.H, method="reservoir",
                      reservoir_slots=512)
    s, i, cert = rec.recommend_certified([0, 1, 2, 3], k=5,
                                         exclude_seen=False)
    full = np.asarray(res.W) @ np.asarray(res.H)
    # contract: certified => exact (a bf16-resolution near-tie may
    # correctly leave a row uncertified, never falsely certified)
    assert cert.sum() >= 3
    for row, u in enumerate([0, 1, 2, 3]):
        exact = set(np.argsort(-full[u])[:5].tolist())
        if cert[row]:
            assert set(i[row].tolist()) == exact

    tiny = Recommender(res.W, res.H, method="reservoir",
                       reservoir_slots=8)
    s2, i2, cert2 = tiny.recommend_certified(np.arange(30), k=5,
                                             exclude_seen=False)
    cert2 = np.asarray(cert2)
    for row in range(30):
        exact = set(np.argsort(-full[row])[:5].tolist())
        if set(np.asarray(i2)[row].tolist()) != exact:
            assert not cert2[row], row  # a miss must not certify


# -- round 5: serving routing + robustness ---------------------------------


def test_foldin_on_padded_reservoir_table(rng):
    """ADVICE r4 (high): a reservoir Recommender pads H to a slots
    multiple at load; fold-in statistics and width checks must use the
    TRUE n_items, so cold-user serving works on a padded table."""
    V, res = _fit(rng, m=50)
    rec = Recommender(res.W, res.H, method="reservoir",
                      reservoir_slots=128)
    assert rec.H.shape[1] == 128 and rec.n_items == 50
    ref = Recommender(res.W, res.H)  # unpadded baseline
    w1 = rec.fold_in([3, 7, 12])
    w2 = ref.fold_in([3, 7, 12])
    np.testing.assert_allclose(w1, w2, rtol=1e-5, atol=1e-6)
    s, i = rec.recommend_from_history([3, 7, 12], k=5)
    assert (i < 50).all()


def test_exact_method_prefers_scatter_lists(rng, monkeypatch):
    """Pin the exclusion routing: method='exact' goes through the
    scatter-list form (top_k cost grows with the candidate width
    k+S), method='approx' keeps oversampling."""
    import nmftpu.serving as serving_mod

    V, res = _fit(rng, n=20, m=200, r=4)
    seen_mask = rng.random((20, 200)) < 0.05
    train = from_dense(np.where(seen_mask, V, 0.0))
    orig = serving_mod.topk_mips_excluded
    calls = []

    def spy(*a, **k):
        calls.append("excluded")
        return orig(*a, **k)

    monkeypatch.setattr(serving_mod, "topk_mips_excluded", spy)
    rec = Recommender(res.W, res.H, train=train, method="exact")
    s, i = rec.recommend([0, 2], k=5, exclude_seen=True)
    assert not calls  # exact never took the oversampling form
    csr = rec._train_csr
    for row, u in enumerate([0, 2]):
        su = set(csr.indices[csr.indptr[u]:csr.indptr[u + 1]].tolist())
        assert not (su & set(i[row].tolist()))
    rec2 = Recommender(res.W, res.H, train=train, method="approx")
    rec2.recommend([0, 2], k=5, exclude_seen=True)
    assert calls  # approx still prefers oversampling


def test_serving_oom_backoff(rng, monkeypatch):
    """A compile/device OOM on the serving scan halves the block and
    retries with a warning instead of surfacing the raw XLA error (the
    f32 r=256 megablock boundary at m=10M)."""
    import pytest as _p

    import nmftpu.serving as serving_mod

    V, res = _fit(rng, n=10, m=300, r=4)
    rec = Recommender(res.W, res.H, method="approx", block=1 << 20)
    orig = serving_mod.topk_mips_blocked

    def fake(*a, block=None, **k):
        if block > (1 << 19):
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: Out of memory while trying to "
                "allocate 21474836480 bytes."
            )
        return orig(*a, block=block, **k)

    monkeypatch.setattr(serving_mod, "topk_mips_blocked", fake)
    with _p.warns(RuntimeWarning, match="retrying with"):
        s, i = rec.recommend([0, 1], k=5, exclude_seen=False)
    assert rec.block == 1 << 19
    ref = Recommender(res.W, res.H, method="approx")
    s2, i2 = ref.recommend([0, 1], k=5, exclude_seen=False)
    np.testing.assert_array_equal(i, i2)


def test_certified_fallback_exact(rng):
    """fallback='exact': uncertified rows are re-scanned exact in the
    same call, so EVERY returned row is the exact top-k; `certified`
    still reports the pass-1 rate."""
    V, res = _fit(rng, m=300)
    full = np.asarray(res.W) @ np.asarray(res.H)
    tiny = Recommender(res.W, res.H, method="reservoir",
                       reservoir_slots=8)
    s, i, cert = tiny.recommend_certified(
        np.arange(30), k=8, exclude_seen=False, fallback="exact")
    assert not cert.all()  # slots=8 over m=300 must miss somewhere
    for row in range(30):
        exact_ids = set(np.argsort(-full[row])[:8].tolist())
        assert set(i[row].tolist()) == exact_ids, row
    with pytest.raises(ValueError, match="fallback"):
        tiny.recommend_certified([0], k=5, fallback="bogus")


def test_certified_wide_seen_degrades(rng):
    """A user whose seen list is too wide for oversampling exclusion
    gets a certified answer through the scatter-list scan + wide-seen
    certify discount — no ValueError."""
    V, res = _fit(rng, n=20, m=300, r=4)
    seen_dense = np.zeros_like(V)
    wide = rng.choice(300, 150, replace=False)
    seen_dense[0, wide] = 1.0
    seen_dense[1, [5, 6]] = 1.0
    rec = Recommender(res.W, res.H, train=from_dense(seen_dense),
                      method="approx", block=64)
    assert rec._seen_padded(rec._train_csr, np.array([0, 1]),
                            k=5) is None  # wide row disqualifies batch
    s, i, cert = rec.recommend_certified([0, 1], k=5, candidate_k=64)
    full = np.asarray(res.W) @ np.asarray(res.H)
    masked = full.copy()
    masked[0, wide] = -np.inf
    masked[1, [5, 6]] = -np.inf
    for row, u in enumerate([0, 1]):
        assert not (set(i[row].tolist())
                    & set(np.flatnonzero(seen_dense[u]).tolist()))
        if cert[row]:
            assert set(i[row].tolist()) == set(
                np.argsort(-masked[u])[:5].tolist())
    s2, i2, _ = rec.recommend_certified([0, 1], k=5, fallback="exact")
    for row, u in enumerate([0, 1]):
        assert set(i2[row].tolist()) == set(
            np.argsort(-masked[u])[:5].tolist())


def test_reservoir_candidate_k_warns(rng):
    """candidate_k does not tune the reservoir scan (reservoir_slots
    does); passing it must warn instead of silently doing nothing."""
    V, res = _fit(rng)
    rec = Recommender(res.W, res.H, method="reservoir",
                      reservoir_slots=128)
    with pytest.warns(UserWarning, match="reservoir_slots"):
        rec.recommend([0], k=5, exclude_seen=False, candidate_k=32)


def test_reservoir_certified_tiny_catalog(rng):
    """k exceeding the available (unseen) catalog: the reservoir
    certified path must not revive filler/seen ids as duplicates when
    re-scoring (ADVICE r4) — tail slots stay -inf."""
    V, res = _fit(rng, n=10, m=20, r=3)
    seen_dense = np.zeros_like(V)
    seen_ids = np.arange(10)
    seen_dense[0, seen_ids] = 1.0
    rec = Recommender(res.W, res.H, train=from_dense(seen_dense),
                      method="reservoir", reservoir_slots=32)
    s, i, cert = rec.recommend_certified([0], k=15)
    fin = np.isfinite(s[0])
    ids = i[0][fin]
    assert fin.sum() == 10  # exactly the unseen catalog
    assert len(set(ids.tolist())) == len(ids)  # no duplicates
    assert not (set(ids.tolist()) & set(seen_ids.tolist()))


def test_sharded_certified_reservoir_and_fallback(rng):
    """Mesh recommend_certified: reservoir candidates re-scored +
    psum'd per-shard certificate; tiny reservoir slots force misses ->
    uncertified rows; fallback='exact' re-scans them through the
    sharded exact path so every row matches brute force."""
    from nmftpu.parallel import make_grid_mesh

    V, res = _fit(rng, n=30, m=320, r=4)
    full = np.asarray(res.W) @ np.asarray(res.H)
    seen_dense = np.zeros_like(V)
    top2 = np.argsort(-full, axis=1)[:, :2]
    for u in range(30):
        seen_dense[u, top2[u]] = 1.0
    mesh = make_grid_mesh((2, 4))
    rec = Recommender(res.W, res.H, train=from_dense(seen_dense),
                      mesh=mesh, method="reservoir", reservoir_slots=8,
                      block=40)
    s, i, cert = rec.recommend_certified(np.arange(20), k=5,
                                         fallback="exact")
    masked = full.copy()
    for u in range(30):
        masked[u, top2[u]] = -np.inf
    for row in range(20):
        exact = set(np.argsort(-masked[row])[:5].tolist())
        assert set(i[row].tolist()) == exact, row
        assert not (set(i[row].tolist()) & set(top2[row].tolist()))
    # sanity: the tiny reservoir really did miss somewhere (the
    # certificate caught it and the fallback repaired it)
    assert not cert.all()


def test_reservoir_candidate_k_warns_on_mesh(rng):
    """The candidate_k no-op warning must fire on the MESH reservoir
    path too (review r5: the sharded scan drops it just the same)."""
    from nmftpu.parallel import make_grid_mesh

    V, res = _fit(rng, m=64)
    rec = Recommender(res.W, res.H, mesh=make_grid_mesh((2, 4)),
                      method="reservoir", reservoir_slots=64)
    with pytest.warns(UserWarning, match="reservoir_slots"):
        rec.recommend([0], k=5, exclude_seen=False, candidate_k=16)


def test_certified_fallback_escalation(rng):
    """fallback='exact' escalates uncertified rows through a 4x-slots
    reservoir pass first (table-read-bound) — most rows certify there
    and skip the sort-bound exact scan; the result is exact either
    way. m=320 is a 4*slots multiple so the escalation reuses the
    padded table zero-copy."""
    V, res = _fit(rng, m=320)
    full = np.asarray(res.W) @ np.asarray(res.H)
    tiny = Recommender(res.W, res.H, method="reservoir",
                       reservoir_slots=8)
    calls = []
    orig = tiny._exact_rows

    def spy(users, k, ex):
        calls.append(len(users))
        return orig(users, k, ex)

    tiny._exact_rows = spy
    s, i, cert = tiny.recommend_certified(
        np.arange(40), k=8, exclude_seen=False, fallback="exact")
    n_unc = int((~cert).sum())
    # escalation is gated on > one exact-scan bucket (16 rows): tiny
    # slots over 40 users must clear it for this test to bite
    assert n_unc > 16, n_unc
    residue = calls[0] if calls else 0
    # the escalated pass must resolve most of the uncertified rows
    assert residue <= max(1, n_unc // 3), (residue, n_unc)
    for row in range(40):
        assert set(i[row].tolist()) == set(
            np.argsort(-full[row])[:8].tolist()), row
