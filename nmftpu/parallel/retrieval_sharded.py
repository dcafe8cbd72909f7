"""Sharded top-k MIPS (SURVEY.md §5.7, BASELINE.json config #5).

Two-stage exact search: every 'items' shard runs the blocked top-k kernel
over its local slice of the item table (k' = k candidates each), then the
per-shard candidate lists are all-gathered over the items axis and merged
with one more top_k — comm volume O(pi * b * k), independent of m.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from nmftpu.parallel.mesh import AXIS_ITEMS, AXIS_USERS
from nmftpu.retrieval.mips import (
    _count_above,
    _drop_seen,
    _gather_scores,
    topk_mips_blocked,
)


def topk_mips_sharded(Wq, H, k, mesh, block=4096, exclude_mask=None,
                      exclude_lists=None, seen=None, method="exact",
                      candidate_k=None, h_scale=None,
                      reservoir_slots=4096, interpret=False):
    """Top-k over an items-sharded table H (r, m).

    Wq: (b, r) queries (replicated); H sharded P(None, 'items');
    exclude_mask: optional (b, m) bool, sharded like H on its item axis —
    O(b·m), small-m only. exclude_lists: (ex_user, ex_col) from
    `build_block_exclusion(..., shards=pi)` — block-bucketed pairs,
    (pi·nblocks_loc, E) shard-major so each shard receives exactly its
    own blocks. seen: (b, S) padded GLOBAL item ids (-1 padding) — the
    OVERSAMPLING exclusion form: every shard retrieves k+S candidates
    scatter-free, the cross-shard merge keeps k+S, and one
    final broadcast-compare drops the seen set. Exact: at most S_u seen
    items can pollute a user's merged list.
    method: "exact", "approx" (hardware approx_max_k inside each shard's
    blocked scan; both cross-block and cross-shard merges exact), or
    "reservoir" (each shard runs the GEMM→top-2-per-slot reservoir
    scan of kernels/mips_reservoir.py over its local table slice —
    per-shard recall ≈ 1 − C(k,3)/reservoir_slots², and the cross-shard
    merge stays exact; exclusion must use `seen`/none, the mask/lists
    forms belong to the blocked scans).
    candidate_k: per-block candidate count for the approx path.
    interpret: reservoir only — run the Triton kernel in the Pallas
    interpreter (tests); otherwise `nmftpu.backend` picks the scan.
    Returns (scores (b, k), global item indices (b, k)), replicated.
    """
    has_mask = exclude_mask is not None
    has_lists = exclude_lists is not None
    has_seen = seen is not None
    if has_seen and (has_mask or has_lists):
        raise ValueError("pass seen OR exclude_mask/exclude_lists, not both")
    if method == "reservoir" and (has_mask or has_lists):
        raise ValueError(
            "method='reservoir' excludes via `seen` (or serve without "
            "exclusion); exclude_mask/exclude_lists need the blocked "
            "scans — use method='approx'"
        )
    kk = k + (int(seen.shape[1]) if has_seen else 0)
    ck = (None if candidate_k is None
          else candidate_k + (kk - k))
    if method == "reservoir" and kk > 2 * reservoir_slots:
        raise ValueError(
            f"k + seen width = {kk} exceeds the 2*reservoir_slots = "
            f"{2 * reservoir_slots} per-shard candidates; raise "
            "reservoir_slots or trim the seen lists"
        )
    def local_topk(Wq, H_loc, *extra):
        m_loc = H_loc.shape[1]
        mask_loc = extra[0] if has_mask else None
        lists_loc = extra[-2:] if has_lists else None
        if method == "reservoir":
            from nmftpu.kernels.mips_reservoir import reservoir_topk_mips

            # seen ids are GLOBAL — exclusion happens after the merge
            s, idx = reservoir_topk_mips(
                Wq, H_loc, kk, slots=reservoir_slots,
                h_scale=h_scale, interpret=interpret,
            )
        else:
            s, idx = topk_mips_blocked(
                Wq, H_loc, kk, block=min(block, m_loc),
                exclude_mask=mask_loc, exclude_lists=lists_loc,
                method=method, candidate_k=ck, h_scale=h_scale,
            )
        shard = lax.axis_index(AXIS_ITEMS)
        gidx = idx + shard * m_loc
        # gather candidates from every item shard, then merge
        all_s = lax.all_gather(s, AXIS_ITEMS)        # (pi, b, kk)
        all_i = lax.all_gather(gidx, AXIS_ITEMS)
        pi, b, _ = all_s.shape
        cand_s = all_s.transpose(1, 0, 2).reshape(b, pi * kk)
        cand_i = all_i.transpose(1, 0, 2).reshape(b, pi * kk)
        top_s, pos = lax.top_k(cand_s, kk)
        top_i = jnp.take_along_axis(cand_i, pos, axis=1)
        if has_seen:
            return _drop_seen(top_s, top_i, extra[-1], k)
        return top_s, top_i

    in_specs = [P(), P(None, AXIS_ITEMS)]
    args = [Wq, H]
    if has_mask:
        in_specs.append(P(None, AXIS_ITEMS))
        args.append(exclude_mask)
    if has_lists:
        in_specs += [P(AXIS_ITEMS, None), P(AXIS_ITEMS, None)]
        args += [jnp.asarray(exclude_lists[0]),
                 jnp.asarray(exclude_lists[1])]
    if has_seen:
        in_specs.append(P())
        args.append(jnp.asarray(seen))

    f = jax.shard_map(
        local_topk, mesh=mesh,
        in_specs=tuple(in_specs), out_specs=(P(), P()),
        check_vma=False,
    )
    return f(*args)


def certify_topk_sharded(Wq, H, top_s, k, mesh, block=4096,
                         h_scale=None, seen=None):
    """The exactness-certificate pass over an items-sharded table.

    Same contract as `retrieval.mips.certify_topk` (count items
    scoring strictly above the kth returned score; count <= k-1 proves
    the row IS the exact top-k up to ties), mesh-native: every items
    shard counts its local slice with the shared blocked
    compare-reduce (`_count_above`) and the counts psum over the items
    axis. The seen discount partitions naturally — each GLOBAL seen id
    lands in exactly one shard's local range, so per-shard discounts
    psum to the global one. H must carry only REAL items per shard (no
    padding columns). Returns certified (b,) bool, replicated.
    """
    import jax

    top_s = jnp.asarray(top_s)
    theta = top_s[:, k - 1]
    has_seen = seen is not None

    def local(Wq, H_loc, theta, *extra):
        m_loc = H_loc.shape[1]
        cnt = _count_above(Wq, H_loc, theta, min(block, m_loc),
                           h_scale)
        if has_seen:
            sn = extra[0]
            shard = lax.axis_index(AXIS_ITEMS)
            loc = sn - shard * m_loc
            valid = (sn >= 0) & (loc >= 0) & (loc < m_loc)
            sc = _gather_scores(
                Wq, H_loc, jnp.clip(loc, 0, m_loc - 1), h_scale)
            cnt = cnt - jnp.sum(
                (sc > theta[:, None]) & valid, axis=1,
                dtype=jnp.int32)
        return lax.psum(cnt, AXIS_ITEMS)

    in_specs = [P(), P(None, AXIS_ITEMS), P()]
    args = [Wq, H, theta]
    if has_seen:
        in_specs.append(P())
        args.append(jnp.asarray(seen))
    f = jax.shard_map(
        local, mesh=mesh, in_specs=tuple(in_specs), out_specs=P(),
        check_vma=False,
    )
    return f(*args) <= k - 1
