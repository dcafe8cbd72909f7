"""Top-k maximum-inner-product search over the item factor table.

The score matrix is W_q @ H — one GEMM — so exact MIPS is a blocked
GEMM + running top-k merge, not an index structure (cf. "To Index
or Not to Index" — exact blocked scan wins at these ranks). The blocked
variant never materializes more than (batch, block) scores, which is also
exactly the per-shard kernel the sharded retrieval path runs before its
cross-shard merge (nmftpu.parallel.retrieval_sharded).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

NEG_INF = -jnp.inf


def _score_dot(Wq, Hblk, h_scale=None):
    """Scoring GEMM with f32 accumulation at the TABLE's dtype (an f32
    table at HIGHEST, see `_table_precision`): a bf16
    item table (`Recommender(table_dtype="bfloat16")`) halves both the
    per-chip table footprint and the scan's HBM read traffic — the exact
    path's bandwidth bill — while the f32 accumulation keeps top-k
    ordering stable (only the ~0.4% per-operand storage rounding
    remains). An int8 table (quarter footprint: 4x the items per chip)
    carries `h_scale`: int8->bf16 is exact, and the positive scale is
    order-preserving — a SCALAR (per-table) folds into the f32 scores
    AFTER the dot; a (rank,) VECTOR (per-dimension, the serving
    default: true H = diag(h_scale) @ H_int8) folds into the QUERY side
    BEFORE the dot (Wq' = Wq * h_scale), costing nothing on the
    scan."""
    if jnp.issubdtype(Hblk.dtype, jnp.integer):
        if h_scale is None:
            raise ValueError(
                "an integer item table needs its quantization scale "
                "(h_scale) — raw int scores would be off by the factor"
            )
        h_scale = jnp.asarray(h_scale)
        if h_scale.ndim == 1:
            Wq = Wq.astype(jnp.float32) * h_scale
        out = lax.dot_general(
            Wq.astype(jnp.bfloat16), Hblk.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return out if h_scale.ndim == 1 else out * h_scale
    if h_scale is not None:
        raise ValueError(
            "h_scale is only meaningful with an integer (quantized) "
            "item table; it would be silently dropped here"
        )
    return lax.dot_general(
        Wq.astype(Hblk.dtype), Hblk,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=_table_precision(Hblk.dtype),
        preferred_element_type=jnp.float32,
    )


def _table_precision(dtype):
    """An f32 table scores at HIGHEST: f32 is the table a caller picks
    for exact scores, and the GPU's default TF32 would round its
    operands to 10 bits. bf16/int8 tables name their own operand
    precision."""
    return lax.Precision.HIGHEST if dtype == jnp.float32 else None


@functools.partial(jax.jit, static_argnames=("k",))
def topk_mips(Wq, H, k, exclude_mask=None, h_scale=None):
    """Exact top-k inner products for a batch of query embeddings.

    Wq: (b, r) query (user) embeddings; H: (r, m) item table (f32 or
    bf16 — see _score_dot). exclude_mask: optional (b, m) bool — True
    entries (e.g. training interactions) are excluded from the
    candidates. Returns (scores (b, k), indices (b, k)).
    """
    scores = _score_dot(Wq, H, h_scale)              # (b, m)
    if exclude_mask is not None:
        scores = jnp.where(exclude_mask, NEG_INF, scores)
    return lax.top_k(scores, k)


def topk_mips_blocked(Wq, H, k, block=4096, exclude_mask=None,
                      exclude_lists=None, method="exact",
                      candidate_k=None, h_scale=None):
    """Memory-bounded top-k: stream item blocks, keep a running top-k.

    Peak memory is (b, block + k) scores instead of (b, m) — required when
    m is the 10M-item axis. H is scanned in (r, block) tiles (zero-padded
    tail; padding scores are -inf so they never surface).

    Seen-item exclusion takes one of two forms:
    * exclude_mask: (b, m) bool — fine at small m, O(b·m) memory;
    * exclude_lists: (ex_user, ex_col) from
      `nmftpu.retrieval.exclusion.build_block_exclusion` — (nblocks, E)
      block-bucketed pairs scattered to -inf inside each block's step,
      O(total_seen) total memory/work, the ONLY viable form at m=10M.

    method="exact" uses `lax.top_k` per block (exact but sort-bound — the
    top-k, not the scoring GEMM, dominates at large m). method="approx"
    uses `lax.approx_max_k` per block (recall target 0.95 per block; the
    cross-block merge stays exact). On the GPU and the CPU, XLA lowers
    `approx_max_k` to its ApproxTopK fallback, an exact sort-and-slice
    top-k (jax/_src/lax/ann.py), so there "approx" returns exact
    per-block results at the exact method's cost.
    candidate_k (approx only): per-block candidate count k' — lower k'
    trades recall for block-sort time, higher k' (> k) buys back
    approx_max_k's per-block recall loss.
    """
    if method not in ("exact", "approx"):
        raise ValueError(
            f"method must be 'exact' or 'approx', got {method!r}"
        )
    if exclude_mask is not None and exclude_lists is not None:
        raise ValueError(
            "pass exclude_mask or exclude_lists, not both"
        )
    if exclude_lists is not None:
        # Host-built lists (the builder returns numpy): catch a
        # block-width mismatch that the nblocks count check alone would
        # miss (same nblocks, different block width => out-of-block
        # local columns would be silently dropped by the scatter).
        ec = exclude_lists[1]
        if isinstance(ec, np.ndarray) and ec.size and int(ec.max()) >= block:
            raise ValueError(
                f"exclude_lists contain block-local column {int(ec.max())}"
                f" >= block={block}; rebuild with this block size"
            )
    return _topk_mips_blocked(
        Wq, H, k, block, exclude_mask, exclude_lists, method,
        candidate_k, h_scale,
    )


def topk_mips_excluded(Wq, H, k, seen, block=4096, method="exact",
                       candidate_k=None, h_scale=None):
    """Blocked top-k MIPS with seen-item exclusion by CANDIDATE
    OVERSAMPLING instead of the per-block score scatter.

    seen: (b, S) int32 item ids per query user, padded with -1.

    Why this form exists: `exclude_lists` scatters -inf into the (b,
    block) score tile, which forces the score buffer to materialize in
    device memory between the GEMM and the top-k. Here the scan runs
    completely exclusion-free retrieving k+S candidates, and the seen
    set is dropped by ONE (b, k+S, S) broadcast-compare at the end —
    exact: at most S_u seen items can pollute a user's candidate list,
    so the true post-exclusion top-k always survives in the top k+S.

    For method="approx", candidate_k is likewise oversampled by S so
    per-block pollution cannot crowd out true candidates.
    """
    seen = jnp.asarray(seen)
    S = seen.shape[1]
    kk = k + S
    if kk > block:
        raise ValueError(
            f"k + seen width = {kk} exceeds block={block}; raise block "
            "or trim the per-user seen lists"
        )
    ck = None if candidate_k is None else candidate_k + S
    s, i = _topk_mips_blocked(Wq, H, kk, block, None, None, method,
                              ck, h_scale)
    return _drop_seen(s, i, seen, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _drop_seen(s, i, seen, k):
    hit = jnp.any(i[:, :, None] == seen[:, None, :], axis=-1)
    s = jnp.where(hit, NEG_INF, s)
    top_s, pos = lax.top_k(s, k)
    return top_s, jnp.take_along_axis(i, pos, axis=1)


def topk_mips_certified(Wq, H, k, block=1048576, candidate_k=None,
                        h_scale=None, seen=None):
    """Approx-speed top-k with a PER-ROW exactness certificate.

    Pass 1 runs the blocked `approx_max_k` scan (megablocks). Pass 2 re-scans the scores counting,
    per row, how many items strictly exceed the returned kth score
    (a GEMM + compare-reduce — fuses, no materialized scores). If that
    count is <= k-1 the approx result provably contains every item that
    beats its kth score, i.e. it IS the exact top-k up to ties AT the
    kth score; `certified[u]` says so. Uncertified rows (approx missed
    something) can be re-run through the exact path by the caller — in
    practice certification rates are ~100% at candidate_k >= 2k.

    seen: optional (b, S) padded item ids excluded exactly (oversampled
    candidates in pass 1; their gathered scores are discounted from the
    count in pass 2).

    Returns (scores (b, k), indices (b, k), certified (b,) bool).
    """
    if seen is not None:
        s, i = topk_mips_excluded(Wq, H, k, seen, block=block,
                                  method="approx",
                                  candidate_k=candidate_k,
                                  h_scale=h_scale)
    else:
        s, i = topk_mips_blocked(Wq, H, k, block=block, method="approx",
                                 candidate_k=candidate_k,
                                 h_scale=h_scale)
    certified = _certify(Wq, H, s, block, h_scale, seen, k)
    return s, i, certified


def certify_topk(Wq, H, top_s, k, block=1048576, h_scale=None,
                 seen=None):
    """The certificate pass alone: given candidate top-k scores from
    ANY scan (megablock approx, the reservoir kernel, ...), count per
    row how many items strictly exceed the kth returned score (GEMM +
    compare-reduce, no materialized scores) — count <= k-1 proves the
    row IS the exact top-k up to ties at that score. `seen` items'
    scores are discounted from the count exactly as in
    `topk_mips_certified`. H must carry only REAL items (no padding
    columns). Returns certified (b,) bool."""
    return _certify(Wq, H, jnp.asarray(top_s), block, h_scale,
                    None if seen is None else jnp.asarray(seen), k)


def _count_above(Wq, H, theta, block, h_scale):
    """Per-row count of items scoring strictly above theta (b,) — the
    certificate's blocked GEMM + compare-reduce; no materialized
    scores. Also the per-shard body of the SHARDED certificate
    (parallel.retrieval_sharded.certify_topk_sharded)."""
    b = Wq.shape[0]
    m = H.shape[1]
    nblocks = (m + block - 1) // block
    pad = nblocks * block - m
    Hp = H if pad == 0 else jnp.pad(H, ((0, 0), (0, pad)))
    col_ids = jnp.arange(block, dtype=jnp.int32)

    def body(blk_idx, cnt):
        Hblk = lax.dynamic_slice_in_dim(Hp, blk_idx * block, block,
                                        axis=1)
        sc = _score_dot(Wq, Hblk, h_scale)        # (b, block) f32
        valid = ((blk_idx * block + col_ids) < m)[None, :]
        return cnt + jnp.sum(
            (sc > theta[:, None]) & valid, axis=1, dtype=jnp.int32
        )

    return lax.fori_loop(0, nblocks, body, jnp.zeros((b,), jnp.int32))


@functools.partial(jax.jit, static_argnames=("block", "k"))
def _certify(Wq, H, top_s, block, h_scale, seen, k):
    m = H.shape[1]
    theta = top_s[:, k - 1]                       # (b,) kth-best score
    count = _count_above(Wq, H, theta, block, h_scale)
    if seen is not None:
        # discount excluded items that score above theta: gather their
        # table columns directly (b*S columns — tiny next to the scan)
        sc_seen = _gather_scores(Wq, H, jnp.clip(seen, 0, m - 1),
                                 h_scale)
        count = count - jnp.sum(
            (sc_seen > theta[:, None]) & (seen >= 0), axis=1,
            dtype=jnp.int32,
        )
    return count <= k - 1


def rescore_and_sort(Wq, H, ids, h_scale=None, invalid=None, seen=None):
    """Re-score candidate ids at the full-scan dtype rules and sort
    descending. Used to align a faster scan's scores (e.g. the
    reservoir kernel's all-bf16 dots) with `certify_topk`'s pass so the
    kth-score threshold is comparable; also upgrades the returned
    scores to the exact path's precision. ids: (b, S) -> (scores,
    ids) both (b, S) sorted by score.

    invalid: optional (b, S) bool — True where the id is a FILLER from
    the upstream scan (e.g. a -inf slot's index 0); re-scoring such a
    position at its true score would resurrect an item the scan never
    selected (a tiny catalog with k > available candidates is the
    failure case), so it stays -inf. seen: optional (b, S2) padded id
    array — seen ids are re-masked to -inf (an upstream seen-drop
    keeps the id with a -inf score; the gather would revive it)."""
    ids = jnp.asarray(ids)
    H = jnp.asarray(H)
    s = _gather_scores(Wq, H, jnp.clip(ids, 0, H.shape[1] - 1), h_scale)
    if invalid is not None:
        s = jnp.where(jnp.asarray(invalid), NEG_INF, s)
    if seen is not None:
        hit = jnp.any(
            ids[:, :, None] == jnp.asarray(seen)[:, None, :], axis=-1
        )
        s = jnp.where(hit, NEG_INF, s)
    top_s, pos = lax.top_k(s, s.shape[1])
    return top_s, jnp.take_along_axis(ids, pos, axis=1)


def _gather_scores(Wq, H, ids, h_scale=None):
    """Scores for specific (query, item) pairs via a column gather +
    batched dot at the SAME dtype rules as `_score_dot` (so the result
    is comparable with a full-scan pass): (b, r) x (r, m)[:, ids] ->
    (b, S) f32 for (b, S) int ids."""
    Hs = jnp.take(H, ids, axis=1)                      # (r, b, S)
    if jnp.issubdtype(H.dtype, jnp.integer):
        hs = jnp.asarray(h_scale)
        wq_eff = (Wq.astype(jnp.float32) * hs
                  if hs.ndim == 1 else Wq)
        sc = jnp.einsum(
            "br,rbs->bs", wq_eff.astype(jnp.bfloat16),
            Hs.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        return sc if hs.ndim == 1 else sc * hs
    return jnp.einsum(
        "br,rbs->bs", Wq.astype(Hs.dtype), Hs,
        precision=_table_precision(Hs.dtype),
        preferred_element_type=jnp.float32,
    )


@functools.partial(
    jax.jit, static_argnames=("k", "block", "method", "candidate_k")
)
def _topk_mips_blocked(Wq, H, k, block, exclude_mask, exclude_lists,
                       method, candidate_k, h_scale=None):
    b, r = Wq.shape
    m = H.shape[1]
    nblocks = (m + block - 1) // block
    pad = nblocks * block - m
    # zero-copy when m divides into blocks (the large-m serving shape);
    # otherwise ONE padded copy — never a transposed per-block stack.
    Hp = H if pad == 0 else jnp.pad(H, ((0, 0), (0, pad)))
    if exclude_mask is not None:
        mask_p = jnp.pad(exclude_mask, ((0, 0), (0, pad)),
                         constant_values=True)
    else:
        mask_p = None
    if exclude_lists is not None:
        ex_user, ex_col = (jnp.asarray(x) for x in exclude_lists)
        if ex_user.shape[0] != nblocks:
            raise ValueError(
                f"exclude_lists built for {ex_user.shape[0]} blocks, "
                f"scan has {nblocks} (m={m}, block={block})"
            )
    else:
        ex_user = ex_col = None

    # approx_max_k's operand is (b, block): clamp the per-block candidate
    # count to the block width (k itself may exceed it)
    kk = (min(k, block) if candidate_k is None
          else max(1, min(candidate_k, block)))

    # padding columns masked off
    col_ids = jnp.arange(block, dtype=jnp.int32)

    def body(blk_idx, carry):
        best_s, best_i = carry           # (b, k) running top-k
        Hblk = lax.dynamic_slice_in_dim(Hp, blk_idx * block, block, axis=1)
        s = _score_dot(Wq, Hblk, h_scale)  # (b, block) f32
        base = blk_idx * block
        ids = (base + col_ids).astype(jnp.int32)
        valid = ids[None, :] < m
        if mask_p is not None:
            mblk = lax.dynamic_slice_in_dim(
                mask_p, blk_idx * block, block, axis=1
            )
            s = jnp.where(valid & ~mblk, s, NEG_INF)
        else:
            s = jnp.where(valid, s, NEG_INF)
        if ex_user is not None:
            eu = lax.dynamic_index_in_dim(ex_user, blk_idx, 0,
                                          keepdims=False)
            ec = lax.dynamic_index_in_dim(ex_col, blk_idx, 0,
                                          keepdims=False)
            # -1 padding must be remapped to a POSITIVE out-of-bounds
            # index: JAX normalizes negative indices NumPy-style before
            # mode="drop" applies, so a raw -1 would wrap to the last
            # row/column and mask a real item.
            eu = jnp.where(eu < 0, b, eu)
            ec = jnp.where(ec < 0, block, ec)
            s = s.at[eu, ec].set(NEG_INF, mode="drop")
        if method == "approx":
            blk_s, blk_pos = lax.approx_max_k(s, kk)
            blk_i = jnp.take_along_axis(
                jnp.broadcast_to(ids, (b, block)), blk_pos, axis=1
            )
            cand_s = jnp.concatenate([best_s, blk_s], axis=1)
            cand_i = jnp.concatenate([best_i, blk_i], axis=1)
            top_s, pos = lax.top_k(cand_s, k)  # exact merge over k + k'
        else:
            cand_s = jnp.concatenate([best_s, s], axis=1)
            cand_i = jnp.concatenate(
                [best_i, jnp.broadcast_to(ids, (b, block))], axis=1
            )
            top_s, pos = lax.top_k(cand_s, k)
        top_i = jnp.take_along_axis(cand_i, pos, axis=1)
        return (top_s, top_i)

    init = (
        jnp.full((b, k), NEG_INF, jnp.float32),
        jnp.zeros((b, k), jnp.int32),
    )
    scores, idx = lax.fori_loop(0, nblocks, body, init)
    return scores, idx
