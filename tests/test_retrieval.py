"""Retrieval tests: blocked top-k MIPS vs. brute force, exclusion masks,
recall@k harness end-to-end on a factorized synthetic matrix."""

import jax.numpy as jnp
import numpy as np
import pytest

from nmftpu import NmfConfig
from nmftpu.driver import compute
from nmftpu.retrieval import recall_at_k, topk_mips, topk_mips_blocked
from nmftpu.sparse import from_dense


def test_topk_matches_bruteforce(rng):
    Wq = rng.standard_normal((7, 8)).astype(np.float32)
    H = rng.standard_normal((8, 100)).astype(np.float32)
    scores, idx = topk_mips(Wq, H, k=5)
    full = Wq @ H
    expect_idx = np.argsort(-full, axis=1)[:, :5]
    np.testing.assert_array_equal(np.asarray(idx), expect_idx)
    np.testing.assert_allclose(
        np.asarray(scores),
        np.take_along_axis(full, expect_idx, axis=1),
        rtol=1e-5,
    )


def test_blocked_topk_matches_full(rng):
    Wq = rng.standard_normal((5, 6)).astype(np.float32)
    H = rng.standard_normal((6, 237)).astype(np.float32)  # non-multiple of block
    s_full, i_full = topk_mips(Wq, H, k=10)
    s_blk, i_blk = topk_mips_blocked(Wq, H, k=10, block=64)
    np.testing.assert_allclose(np.asarray(s_blk), np.asarray(s_full),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(i_blk), np.asarray(i_full))


def test_exclusion_mask(rng):
    Wq = rng.standard_normal((3, 4)).astype(np.float32)
    H = rng.standard_normal((4, 50)).astype(np.float32)
    full = Wq @ H
    best = np.argmax(full, axis=1)
    mask = np.zeros((3, 50), dtype=bool)
    mask[np.arange(3), best] = True  # exclude each row's best item
    _, idx = topk_mips_blocked(Wq, H, k=5, block=16, exclude_mask=mask)
    for b in range(3):
        assert best[b] not in np.asarray(idx)[b]


def test_recall_at_k_end_to_end(rng):
    """Factorize a strongly structured matrix; held-out strong interactions
    must be recalled far above chance."""
    n, m, r = 60, 80, 4
    Wt = rng.uniform(0.0, 1.0, (n, r)) ** 2
    Ht = rng.uniform(0.0, 1.0, (r, m)) ** 2
    V = (Wt @ Ht).astype(np.float32)

    # per-user strongest item held out
    held = np.argmax(V, axis=1)
    train_dense = V.copy()
    test_pairs = np.stack([np.arange(n), held], axis=1)
    train_dense[np.arange(n), held] = 0.0

    res = compute(train_dense, NmfConfig(rank=r, num_iterations=300, seed=0))
    rec = recall_at_k(
        res.W, res.H, test_pairs, train=from_dense(train_dense),
        k=10, batch_users=32, block=32,
    )
    assert rec > 0.5, f"recall@10 = {rec}"


def test_recall_perfect_with_true_factors(rng):
    n, m, r = 30, 40, 3
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    V = W @ H
    held = np.argmax(V, axis=1)
    test_pairs = np.stack([np.arange(n), held], axis=1)
    rec = recall_at_k(W, H, test_pairs, train=None, k=1, batch_users=16)
    assert rec == 1.0


def test_approx_topk_high_overlap(rng):
    """approx_max_k path: strong overlap with exact top-k (XLA's
    fallback on the CPU and the GPU is an exact sort)."""
    Wq = rng.standard_normal((6, 8)).astype(np.float32)
    H = rng.standard_normal((8, 300)).astype(np.float32)
    _, i_ex = topk_mips_blocked(Wq, H, k=10, block=64, method="exact")
    _, i_ap = topk_mips_blocked(Wq, H, k=10, block=64, method="approx")
    overlap = np.mean([
        len(set(np.asarray(i_ex)[b]) & set(np.asarray(i_ap)[b])) / 10
        for b in range(6)
    ])
    assert overlap >= 0.8, overlap


def test_exclude_lists_match_dense_mask(rng):
    """Block-bucketed exclusion lists == dense mask exclusion (the 10M-item
    form vs the small-m form), exact and approx."""
    from nmftpu.retrieval.exclusion import build_block_exclusion
    from nmftpu.sparse import SparseCSR

    n, m, r = 24, 200, 5
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    # random seen sets
    dense_seen = rng.uniform(size=(n, m)) < 0.15
    indptr = np.concatenate([[0], np.cumsum(dense_seen.sum(1))]).astype(np.int64)
    indices = np.concatenate([np.nonzero(row)[0] for row in dense_seen])
    csr = SparseCSR(indptr, indices.astype(np.int64),
                    np.ones(len(indices), np.float32), (n, m))

    user_ids = np.arange(n)
    for method in ("exact", "approx"):
        lists = build_block_exclusion(user_ids, csr, m, block=64)
        _, i_lists = topk_mips_blocked(
            W, H, k=8, block=64, exclude_lists=lists, method=method)
        _, i_mask = topk_mips_blocked(
            W, H, k=8, block=64, exclude_mask=dense_seen, method=method)
        np.testing.assert_array_equal(np.asarray(i_lists),
                                      np.asarray(i_mask))
        # nothing seen may surface
        for u in range(n):
            assert not dense_seen[u, np.asarray(i_lists)[u]].any()


def test_exclude_lists_uneven_tail_block(rng):
    """m not divisible by block: the tail block's local columns must
    still be excluded correctly."""
    from nmftpu.retrieval.exclusion import build_block_exclusion
    from nmftpu.sparse import SparseCSR

    n, m = 4, 100  # block 32 -> 4 blocks, tail width 4
    W = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (3, m)).astype(np.float32)
    # seen items in the tail block for every user
    seen = np.array([[97, 98], [96, 99], [0, 99], [98, 99]])
    indptr = np.arange(0, 2 * n + 1, 2).astype(np.int64)
    csr = SparseCSR(indptr, seen.reshape(-1).astype(np.int64),
                    np.ones(2 * n, np.float32), (n, m))
    lists = build_block_exclusion(np.arange(n), csr, m, block=32)
    _, idx = topk_mips_blocked(W, H, k=m - 2, block=32,
                               exclude_lists=lists)
    idx = np.asarray(idx)
    for u in range(n):
        assert not set(seen[u]).intersection(idx[u].tolist())


def test_candidate_k_tuning(rng):
    """approx candidate_k: k' >= k runs and k' > k recall >= k' = small."""
    n, m, r = 16, 2048, 8
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    _, i_exact = topk_mips_blocked(W, H, k=32, block=256, method="exact")

    def recall(i_got):
        got = np.asarray(i_got)
        want = np.asarray(i_exact)
        return np.mean([
            len(set(got[u]) & set(want[u])) / want.shape[1]
            for u in range(n)
        ])

    _, i_small = topk_mips_blocked(W, H, k=32, block=256,
                                   method="approx", candidate_k=8)
    _, i_big = topk_mips_blocked(W, H, k=32, block=256,
                                 method="approx", candidate_k=64)
    assert recall(i_big) >= recall(i_small)
    assert recall(i_big) > 0.9


def test_exclude_lists_padding_does_not_wrap(rng):
    """Regression: JAX normalizes negative scatter indices BEFORE
    mode="drop", so the -1 padding used to wrap to (last user, last
    block column) and silently mask a real item. A user with NO seen
    items (all their entries are padding) must get the exact
    unexcluded top-k."""
    from nmftpu.retrieval.exclusion import build_block_exclusion
    from nmftpu.sparse import SparseCSR

    n, m, r = 2, 8, 3
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    # user 0 has seen items, user 1 has none -> every block of user 1
    # is pure -1 padding
    seen = np.array([0, 5])
    indptr = np.array([0, 2, 2], np.int64)
    csr = SparseCSR(indptr, seen.astype(np.int64),
                    np.ones(2, np.float32), (n, m))
    lists = build_block_exclusion(np.arange(n), csr, m, block=4)
    _, idx = topk_mips_blocked(W, H, k=3, block=4, exclude_lists=lists)

    full = W @ H
    expect_u1 = np.argsort(-full[1])[:3]  # nothing excluded for user 1
    np.testing.assert_array_equal(np.asarray(idx)[1], expect_u1)
    masked = full[0].copy()
    masked[seen] = -np.inf
    np.testing.assert_array_equal(
        np.asarray(idx)[0], np.argsort(-masked)[:3]
    )


def test_recall_ignores_inf_padding_slots(rng):
    """When fewer than k valid candidates exist, the -inf filler slots
    (index 0) must not count as recommendations of item 0."""
    from nmftpu.sparse import SparseCSR

    n, m, r = 2, 6, 2
    W = rng.uniform(0.5, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.5, 1.0, (r, m)).astype(np.float32)
    # user 0 has seen EVERY item except their held-out item 0 -> with
    # k=4 > 1 valid candidate, 3 slots are -inf fillers at index 0
    seen = np.array([[0, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 0]], bool)
    indptr = np.concatenate([[0], np.cumsum(seen.sum(1))]).astype(np.int64)
    indices = np.concatenate([np.nonzero(row)[0] for row in seen])
    csr = SparseCSR(indptr, indices.astype(np.int64),
                    np.ones(len(indices), np.float32), (n, m))
    # user 1 holds out item 3; user 0 holds out item 0 (still a candidate)
    rec = recall_at_k(W, H, np.array([[0, 0], [1, 3]]), train=csr,
                      k=4, block=4)
    # user 0's only candidate IS item 0 -> hit; user 1: depends on scores
    assert 0.0 <= rec <= 1.0
    # the stricter check: a held-out item 0 for a user whose top-k is
    # all fillers must NOT hit
    seen_all = np.ones((1, m), bool)
    seen_all[0, 0] = True  # user saw everything incl. 0
    indptr = np.array([0, m], np.int64)
    csr_all = SparseCSR(indptr, np.arange(m, dtype=np.int64),
                        np.ones(m, np.float32), (1, m))
    rec0 = recall_at_k(W[:1], H, np.array([[0, 0]]), train=csr_all,
                       k=4, block=4)
    assert rec0 == 0.0  # every slot is a filler; item 0 must not "hit"


def test_approx_k_exceeds_block(rng):
    """method='approx' with k > block must run (per-block candidates
    clamp to the block width)."""
    W = rng.uniform(0.1, 1.0, (3, 4)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (4, 96)).astype(np.float32)
    s_ap, i_ap = topk_mips_blocked(W, H, k=48, block=32, method="approx")
    s_ex, i_ex = topk_mips_blocked(W, H, k=48, block=32, method="exact")
    assert s_ap.shape == (3, 48)
    # on CPU approx degrades to exact: same candidate sets
    for b in range(3):
        assert set(np.asarray(i_ap)[b]) == set(np.asarray(i_ex)[b])


def test_exclusion_block_width_mismatch_rejected(rng):
    """Lists built for one block width cannot silently drop exclusions
    when scanned at another width that happens to give the same
    nblocks."""
    from nmftpu.retrieval.exclusion import build_block_exclusion
    from nmftpu.sparse import SparseCSR

    n, m = 2, 100
    W = rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (3, m)).astype(np.float32)
    seen = np.array([[55, 56], [57, 58]])
    indptr = np.arange(0, 2 * n + 1, 2).astype(np.int64)
    csr = SparseCSR(indptr, seen.reshape(-1).astype(np.int64),
                    np.ones(2 * n, np.float32), (n, m))
    lists = build_block_exclusion(np.arange(n), csr, m, block=60)
    with pytest.raises(ValueError, match="block"):
        topk_mips_blocked(W, H, k=5, block=51, exclude_lists=lists)


def test_sharded_seen_exclusion_matches_lists(rng):
    """topk_mips_sharded's oversampling `seen` form matches the
    block-bucketed scatter-lists form exactly across exact and approx
    methods (same two-stage merge; the seen set is dropped by one
    broadcast-compare after the cross-shard merge)."""
    from nmftpu.parallel import make_grid_mesh, topk_mips_sharded
    from nmftpu.retrieval.exclusion import build_block_exclusion
    from nmftpu.sparse import SparseCSR

    b, r, m, k, block = 24, 8, 1024, 12, 64
    mesh = make_grid_mesh((2, 4))
    pi = mesh.shape["items"]
    H = jnp.asarray(rng.standard_normal((r, m)).astype(np.float32))
    Wq = jnp.asarray(rng.standard_normal((b, r)).astype(np.float32))
    counts = rng.integers(1, 30, b)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    idx = rng.integers(0, m, int(indptr[-1])).astype(np.int64)
    csr = SparseCSR(indptr, idx, np.ones(len(idx), np.float32), (b, m))
    lists = build_block_exclusion(np.arange(b), csr, m, block, shards=pi)
    S = int(counts.max())
    seen = np.full((b, S), -1, np.int32)
    for u in range(b):
        su = np.unique(idx[indptr[u]:indptr[u + 1]])
        seen[u, :len(su)] = su
    import jax

    H_dev = jax.device_put(
        H, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, "items"))
    )
    s1, i1 = topk_mips_sharded(Wq, H_dev, k, mesh=mesh, block=block,
                               exclude_lists=lists)
    s2, i2 = topk_mips_sharded(Wq, H_dev, k, mesh=mesh, block=block,
                               seen=jnp.asarray(seen))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-6)
    for u in range(b):
        assert (set(np.asarray(i1)[u].tolist())
                == set(np.asarray(i2)[u].tolist())), u
        su = set(idx[indptr[u]:indptr[u + 1]].tolist())
        assert not (su & set(np.asarray(i2)[u].tolist()))
    # approx path with oversampled candidates: high recall, no seen items
    s3, i3 = topk_mips_sharded(Wq, H_dev, k, mesh=mesh, block=block,
                               seen=jnp.asarray(seen), method="approx",
                               candidate_k=32)
    rec = np.mean([
        len(set(np.asarray(i3)[u].tolist())
            & set(np.asarray(i1)[u].tolist())) / k for u in range(b)
    ])
    assert rec > 0.95, rec
    with pytest.raises(ValueError, match="not both"):
        topk_mips_sharded(Wq, H_dev, k, mesh=mesh, block=block,
                          seen=jnp.asarray(seen), exclude_lists=lists)


def test_certified_topk(rng):
    """topk_mips_certified: certified rows equal the exact result up to
    ties at the kth score; the certificate actually detects misses
    (forcing a tiny candidate budget must flip rows to uncertified
    rather than silently returning wrong results as 'exact')."""
    from nmftpu.retrieval.mips import topk_mips_certified

    b, r, m, k = 32, 8, 4096, 10
    H = jnp.asarray(rng.standard_normal((r, m)).astype(np.float32))
    Wq = jnp.asarray(rng.standard_normal((b, r)).astype(np.float32))
    s_ex, i_ex = topk_mips_blocked(Wq, H, k, block=512)
    s, i, cert = topk_mips_certified(Wq, H, k, block=512,
                                     candidate_k=2 * k)
    cert = np.asarray(cert)
    assert cert.all(), f"{cert.sum()}/{b} certified at ck=2k"
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ex),
                               rtol=1e-6)
    for u in range(b):
        assert (set(np.asarray(i)[u].tolist())
                == set(np.asarray(i_ex)[u].tolist())), u

    # with seen exclusion: certificate discounts excluded high scorers
    seen = np.full((b, 6), -1, np.int32)
    # exclude each user's top-3 EXACT items — they all score above the
    # post-exclusion kth score, the exact case the discount exists for
    seen[:, :3] = np.asarray(i_ex)[:, :3]
    s1, i1 = topk_mips_blocked(
        Wq, H, k, block=512,
        exclude_mask=jnp.zeros((b, m), bool).at[
            np.repeat(np.arange(b), 3), seen[:, :3].reshape(-1)
        ].set(True))
    s2, i2, cert2 = topk_mips_certified(Wq, H, k, block=512,
                                        candidate_k=2 * k,
                                        seen=jnp.asarray(seen))
    cert2 = np.asarray(cert2)
    assert cert2.all(), f"{cert2.sum()}/{b} certified with seen"
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-6)
    for u in range(b):
        assert (set(np.asarray(i2)[u].tolist())
                == set(np.asarray(i1)[u].tolist())), u


def test_certified_topk_detects_misses(rng):
    """Starving the candidate budget (candidate_k=1 per block, fewer
    total candidates than k) must yield certified=False, never a wrong
    result labeled exact."""
    from nmftpu.retrieval.mips import topk_mips_certified

    b, r, m, k = 8, 4, 4096, 10
    H = jnp.asarray(rng.standard_normal((r, m)).astype(np.float32))
    Wq = jnp.asarray(rng.standard_normal((b, r)).astype(np.float32))
    # 8 blocks x 1 candidate = 8 < k=10 -> top-k carries -inf slots
    s, i, cert = topk_mips_certified(Wq, H, k, block=512, candidate_k=1)
    assert not np.asarray(cert).any()


# ---------------------------------------------------------------------------
# Reservoir MIPS scan (kernels/mips_reservoir.py): the Triton kernel in
# the Pallas interpreter and the plain XLA scan, against the slotwise
# oracle; the on-card comparison is tests/test_gpu.py.
# ---------------------------------------------------------------------------


def _slotwise_top2_oracle(full, slots):
    """NumPy oracle: per (query, slot) keep the best-two (score, id)
    pairs, slot = item_id mod slots — exactly the kernel's reduction."""
    b, m = full.shape
    cand_s = np.full((b, 2 * slots), -np.inf, np.float32)
    cand_i = np.zeros((b, 2 * slots), np.int32)
    for q in range(b):
        for slot in range(slots):
            ids = np.arange(slot, m, slots)
            if ids.size == 0:
                continue
            order = np.argsort(-full[q, ids], kind="stable")[:2]
            for pos, o in enumerate(order):
                cand_s[q, slot + pos * slots] = full[q, ids[o]]
                cand_i[q, slot + pos * slots] = ids[o]
    return cand_s, cand_i


def test_reservoir_matches_slotwise_oracle(rng):
    from nmftpu.kernels.mips_reservoir import reservoir_topk_mips

    b, r, m, k, slots = 8, 8, 500, 10, 128  # m not a multiple of slots
    Wq = rng.standard_normal((b, r)).astype(np.float32)
    H = rng.standard_normal((r, m)).astype(np.float32)
    full = (Wq.astype(np.float64) @ H.astype(np.float64))
    s, i = reservoir_topk_mips(jnp.asarray(Wq), jnp.asarray(H), k,
                               slots=slots, q_block=8, interpret=True)
    s, i = np.asarray(s), np.asarray(i)
    cand_s, _ = _slotwise_top2_oracle(full.astype(np.float32), slots)
    expect_s = -np.sort(-cand_s, axis=1)[:, :k]
    # bf16 scoring: ids must point at items whose TRUE score matches the
    # returned score, and the score set must match the oracle's top-k set
    np.testing.assert_allclose(s, expect_s, rtol=3e-2, atol=3e-2)
    for q in range(b):
        np.testing.assert_allclose(s[q], full[q, i[q]], rtol=3e-2,
                                   atol=3e-2)
        assert len(set(i[q].tolist())) == k  # no duplicate ids


def test_reservoir_exact_when_slots_cover_items(rng):
    """slots >= m gives every item its own slot — the reservoir is then
    the exact top-k (up to bf16 scoring)."""
    from nmftpu.kernels.mips_reservoir import reservoir_topk_mips
    from nmftpu.retrieval import topk_mips

    b, r, m, k = 4, 16, 100, 7
    Wq = rng.standard_normal((b, r)).astype(np.float32)
    H = rng.standard_normal((r, m)).astype(np.float32)
    s_ex, i_ex = topk_mips(jnp.asarray(Wq).astype(jnp.bfloat16),
                           jnp.asarray(H).astype(jnp.bfloat16), k)
    s, i = reservoir_topk_mips(jnp.asarray(Wq),
                               jnp.asarray(H).astype(jnp.bfloat16), k,
                               slots=128, q_block=4, interpret=True)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ex))


def test_reservoir_seen_exclusion_and_int8(rng):
    from nmftpu.kernels.mips_reservoir import reservoir_topk_mips

    b, r, m, k = 4, 8, 256, 5
    Wq = rng.standard_normal((b, r)).astype(np.float32)
    H = rng.standard_normal((r, m)).astype(np.float32)
    scale = np.abs(H).max() / 127.0
    H8 = np.clip(np.round(H / scale), -127, 127).astype(np.int8)
    full = Wq @ (H8.astype(np.float32) * scale)
    top = np.argsort(-full, axis=1)
    seen = np.full((b, 3), -1, np.int32)
    seen[:, :2] = top[:, :2]  # exclude each query's top-2
    s, i = reservoir_topk_mips(
        jnp.asarray(Wq), jnp.asarray(H8), k, slots=256,
        seen=jnp.asarray(seen), h_scale=scale, q_block=4,
        interpret=True)
    i = np.asarray(i)
    for q in range(b):
        assert not (set(i[q].tolist()) & set(seen[q, :2].tolist()))
        # exact post-exclusion top-k (slots >= m -> reservoir exact)
        assert set(i[q].tolist()) == set(top[q, 2:2 + k].tolist())


def test_reservoir_int8_requires_scale(rng):
    from nmftpu.kernels.mips_reservoir import reservoir_topk_mips

    Wq = jnp.asarray(rng.standard_normal((2, 4)).astype(np.float32))
    H8 = jnp.zeros((4, 64), jnp.int8)
    with pytest.raises(ValueError, match="quantization scale"):
        reservoir_topk_mips(Wq, H8, 3, slots=64, q_block=2,
                            interpret=True)


@pytest.mark.parametrize("b,r,m,slots,dtype", [
    (16, 16, 512, 32, np.float32),      # exact tiles, one query block
    (5, 32, 1000, 64, np.float32),      # odd batch, padded table
    (37, 64, 700, 16, "bfloat16"),      # several query blocks
    (20, 16, 333, 128, "int8"),         # fewer items than a tile row
])
def test_reservoir_kernel_matches_plain(rng, b, r, m, slots, dtype):
    """The Triton scan (Pallas interpreter) and the plain XLA scan give
    the same candidates: same ids, scores to f32 summation order."""
    from nmftpu.kernels import mips_reservoir as M

    Wq = jnp.asarray(rng.standard_normal((b, r)).astype(np.float32))
    Hf = rng.standard_normal((r, m)).astype(np.float32)
    Hf[:, slots + 3] = Hf[:, 3]                 # a tie within one slot
    if dtype == "int8":
        H = jnp.asarray(np.clip(np.round(Hf * 40), -127, 127), jnp.int8)
    else:
        H = jnp.asarray(Hf, jnp.dtype(dtype))
    mp = -(-m // slots) * slots
    Hp = jnp.pad(H, ((0, 0), (0, mp - m)))
    bp = -(-b // 16) * 16
    ks, ki = M._scan_kernel(jnp.pad(Wq, ((0, bp - b), (0, 0))), Hp, m,
                            slots, 16, 16, True)
    ps, pi = M._scan_plain(Wq, Hp, m, slots)
    np.testing.assert_array_equal(np.asarray(ki[:b]), np.asarray(pi))
    np.testing.assert_allclose(np.asarray(ks[:b]), np.asarray(ps),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("m,slots,chunk", [
    (500, 128, 1 << 20),    # one plain step
    (1000, 64, 128),        # several steps and a tail step
    (64, 64, 64),           # one tile
])
def test_plain_reservoir_matches_slotwise_oracle(rng, monkeypatch, m,
                                                 slots, chunk):
    """The plain scan keeps exactly the oracle's best two per slot,
    whatever the number of tiles it merges per step."""
    from nmftpu.kernels import mips_reservoir as M

    monkeypatch.setattr(M, "_PLAIN_CHUNK", chunk)
    b, r = 6, 8
    Wq = rng.standard_normal((b, r)).astype(np.float32)
    H = rng.standard_normal((r, m)).astype(np.float32)
    mp = -(-m // slots) * slots
    Hp = jnp.pad(jnp.asarray(H), ((0, 0), (0, mp - m)))
    got_s, got_i = M._scan_plain(jnp.asarray(Wq), Hp, m, slots)
    # the oracle scores at the scan's bf16 operand rounding
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    full = bf(Wq).astype(np.float64) @ bf(H).astype(np.float64)
    cand_s, cand_i = _slotwise_top2_oracle(full.astype(np.float32), slots)
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    finite = np.isfinite(cand_s)
    np.testing.assert_array_equal(np.isfinite(got_s), finite)
    np.testing.assert_allclose(got_s[finite], cand_s[finite], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got_i[finite], cand_i[finite])


def test_merge_top2_keeps_lower_ids_on_ties():
    """Merging two top-2 lists per slot: the earlier list wins ties, as
    a sequential scan over increasing ids does."""
    from nmftpu.kernels.mips_reservoir import _merge_top2

    f = lambda *x: jnp.asarray(x, jnp.float32)
    i = lambda *x: jnp.asarray(x, jnp.int32)
    s1, i1, s2, i2 = _merge_top2(
        f(5, 5, 3), i(0, 0, 0), f(1, 4, 2), i(1, 1, 1),
        f(5, 4, 9), i(2, 2, 2), f(4, 1, 3), i(3, 3, 3))
    np.testing.assert_array_equal(np.asarray(s1), [5, 5, 9])
    np.testing.assert_array_equal(np.asarray(i1), [0, 0, 2])
    np.testing.assert_array_equal(np.asarray(s2), [5, 4, 3])
    np.testing.assert_array_equal(np.asarray(i2), [2, 1, 0])
