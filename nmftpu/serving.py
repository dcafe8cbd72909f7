"""Serving layer (BASELINE.json config #5): the learned factors as
embedding tables behind a recommend/score API.

`Recommender` wraps W/H (optionally sharded over a mesh) plus the training
interactions (for seen-item exclusion) and serves exact top-k MIPS
recommendations; `save`/`load` persist the tables for a serving process
that never touches the trainer.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np

from nmftpu.retrieval.mips import topk_mips_blocked, topk_mips_excluded
from nmftpu.sparse import SparseCSR, SparseMatrix

# Single-device approx/exact serving scans MEGABLOCKS: fewer, larger
# scoring GEMMs and top-k steps per batch. The value is not tuned for
# the GPU yet (chip_smoke.py prints it beside the per-batch times).
_SERVE_BLOCK = 1 << 20
# Oversampling exclusion retrieves k+S candidates and drops seen items
# with one broadcast-compare at the end (exact; keeps the GEMM->scan
# fusion the per-block scatter breaks). Falls back to the scatter-list
# form when the batch's widest seen list would blow up the candidate
# width.
_MAX_OVERSAMPLE_SEEN = 4096
# Compile/device OOM backoff: a large table with a large megablock can
# raise RESOURCE_EXHAUSTED inside XLA; serving halves the block and
# retries instead of surfacing the raw compiler error.
_MIN_SERVE_BLOCK = 1 << 14
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Resource exhausted",
                "Out of memory", "out of memory",
                "Attempting to allocate")


def _is_oom(exc: BaseException) -> bool:
    return any(m in str(exc) for m in _OOM_MARKERS)


class Recommender:
    """Top-k recommendation serving over factor embedding tables."""

    def __init__(self, W, H, train: SparseMatrix | None = None,
                 mesh=None, block: int | None = None,
                 method: str = "approx", table_dtype: str = "float32",
                 reservoir_slots: int = 4096):
        import jax
        import jax.numpy as jnp

        if table_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"table_dtype must be float32|bfloat16|int8, "
                f"got {table_dtype!r}"
            )
        if method not in ("approx", "exact", "reservoir"):
            raise ValueError(
                f"method must be approx|exact|reservoir, got {method!r}"
            )
        self.W = np.asarray(W)  # queries stay f32 (row-gathered, small)
        self.mesh = mesh
        if block is None:
            # sharded scans keep the historical default (the exclusion
            # lists are bucketed per shard-block); single-device scans
            # take the megablock serving path, clamped to the catalog
            # (a block wider than m would PAD the table to block width)
            m_items = int(np.asarray(H).shape[1])
            block = (8192 if mesh is not None
                     else max(1, min(_SERVE_BLOCK, m_items)))
        self.block = block
        # "approx": lax.approx_max_k per block. On the GPU and the CPU
        # XLA lowers it to an exact sort-and-slice top-k (ApproxTopK's
        # fallback), so there it costs what "exact" costs.
        self.method = method
        self.table_dtype = table_dtype
        # the ITEM table is the scanned operand: bf16 halves / int8
        # quarters its per-chip footprint (2x/4x the items per chip at
        # the 10M scale) and the exact path's HBM read traffic; scores
        # accumulate f32 either way. int8 uses PER-DIMENSION symmetric
        # scales (true H = diag(scale) @ Hq): NMF factor rows span
        # orders of magnitude (topic popularity), so a single per-table
        # scale crushes the quiet dimensions to ±1 int8 levels; the
        # (r,) vector folds into the query side before the scoring dot
        # — order-preserving per query, zero scan cost.
        self._h_scale = None
        if table_dtype == "int8":
            Hf = np.asarray(H, dtype=np.float32)
            sc = np.maximum(np.abs(Hf).max(axis=1) / 127.0, 1e-30)
            self._h_scale = sc.astype(np.float32)
            H_dev = jnp.asarray(
                np.clip(np.round(Hf / sc[:, None]), -127, 127)
                .astype(np.int8)
            )
        else:
            H_dev = jnp.asarray(np.asarray(H), dtype=jnp.dtype(table_dtype))
        # the reservoir scan reads (r, slots) tiles: pad the table to a
        # slots multiple ONCE at load (a per-call pad would copy the
        # multi-GB table every batch); n_items/save stay at the true m
        self.reservoir_slots = int(reservoir_slots)
        self._m_items = int(H_dev.shape[1])
        self._H_unpadded = None  # lazy slice cache for fallback paths
        if method == "reservoir" and mesh is None:
            # sharded tables keep their mesh layout; each shard's scan
            # pads its local slice inside the kernel wrapper instead
            pad = (-self._m_items) % self.reservoir_slots
            if pad:
                H_dev = jnp.pad(H_dev, ((0, 0), (0, pad)))
        if mesh is not None:
            from nmftpu.parallel import factor_shardings

            self.H = jax.device_put(H_dev, factor_shardings(mesh)["H"])
        else:
            self.H = jax.device_put(H_dev)
        self._train_csr = train.to_csr() if train is not None else None
        self._prepared = None  # lazy fold-in table stats (prepare_table)

    def _prep(self):
        """Fold-in table invariants, built once per Recommender (the
        O(r²m) Gram and (m, r) transpose must not be rebuilt per
        request)."""
        if self._prepared is None:
            from nmftpu.foldin import prepare_table

            # the UNPADDED table: a reservoir Recommender pads self.H to
            # a slots multiple, and fold-in width checks / statistics
            # must see the true n_items (padding columns are zeros, but
            # the (b, n_items) history CSR would fail the shape check)
            self._prepared = prepare_table(self._serve_table(),
                                           scale=self._h_scale)
        return self._prepared

    def _scan_with_backoff(self, run):
        """Execute `run()` (a full serving scan built against
        self.block), halving the block and retrying on a device/compile
        OOM. `run` must re-derive everything block-dependent (exclusion
        lists) on each call, and MUST return host (numpy) arrays: JAX
        dispatch is async, so a device-side OOM only surfaces at
        materialization — a run() returning device futures would raise
        outside this guard."""
        while True:
            try:
                return run()
            except Exception as e:  # noqa: BLE001 — filtered by _is_oom
                if not _is_oom(e) or self.block <= _MIN_SERVE_BLOCK:
                    raise
                new_block = max(_MIN_SERVE_BLOCK, self.block // 2)
                hint = ("a bfloat16/int8 table_dtype shrinks the scan "
                        "footprint 2-4x")
                if self.method == "reservoir":
                    # the reservoir scan is block-independent — if
                    # the failure persists across retries the relevant
                    # knobs are reservoir_slots / table_dtype (block
                    # only drives the certify/fallback scans)
                    hint = ("for method='reservoir', reservoir_slots "
                            "and table_dtype are the scan-side knobs "
                            "— block only affects the certify/fallback "
                            "scans")
                warnings.warn(
                    f"serving scan exhausted device memory at "
                    f"block={self.block}; retrying with "
                    f"block={new_block} ({hint})",
                    RuntimeWarning, stacklevel=3,
                )
                self.block = new_block

    def _topk(self, Wq, k, lists, candidate_k, seen=None):
        """Shared blocked/sharded top-k dispatch for all serving entry
        points. Single-device exclusion prefers the oversampling form
        (`seen`, a padded (b, S) id array) — it preserves the
        GEMM->scan fusion the per-block scatter breaks; `lists` is the
        sharded / wide-seen fallback."""
        if (self.method == "reservoir" and candidate_k is not None
                and lists is None):
            # applies to the mesh path too (topk_mips_sharded's
            # reservoir branch drops candidate_k just the same); the
            # lists fallback runs the blocked approx scan, where
            # candidate_k IS honored
            warnings.warn(
                "candidate_k has no effect on the reservoir scan — "
                "its recall is tuned via reservoir_slots (missed "
                "items ~ C(k,3)/slots^2)", UserWarning, stacklevel=3,
            )
        if self.mesh is not None:
            from nmftpu.parallel import topk_mips_sharded

            # scatter-lists exclusion needs the blocked scans — a
            # reservoir server with wide seen lists falls back to the
            # sharded approx path for that batch
            method = self.method
            if method == "reservoir" and lists is not None:
                method = "approx"
            return topk_mips_sharded(
                Wq, self.H, k, mesh=self.mesh, block=self.block,
                exclude_lists=lists, seen=seen, method=method,
                candidate_k=candidate_k, h_scale=self._h_scale,
                reservoir_slots=self.reservoir_slots,
            )
        if self.method == "reservoir":
            from nmftpu.kernels.mips_reservoir import reservoir_topk_mips

            if lists is None:
                # GEMM + top-2-per-slot reservoir scan (nmftpu.backend
                # picks the Triton kernel or the plain XLA form);
                # exclusion rides the same oversampled drop over the
                # 2*slots candidates
                return reservoir_topk_mips(
                    Wq, self.H, k, slots=self.reservoir_slots,
                    seen=None if seen is None else np.asarray(seen),
                    h_scale=self._h_scale, m_items=self._m_items,
                )
            # wide-seen scatter-lists fallback: megablock approx scan
            # over the unpadded table (lists treat every column as real)
            return topk_mips_blocked(
                Wq, self._serve_table(), k, block=self.block,
                exclude_lists=lists, method="approx",
                candidate_k=candidate_k, h_scale=self._h_scale,
            )
        if seen is not None:
            return topk_mips_excluded(
                Wq, self.H, k, seen, block=self.block,
                method=self.method, candidate_k=candidate_k,
                h_scale=self._h_scale,
            )
        return topk_mips_blocked(
            Wq, self.H, k, block=self.block, exclude_lists=lists,
            method=self.method, candidate_k=candidate_k,
            h_scale=self._h_scale,
        )

    @property
    def n_users(self) -> int:
        return self.W.shape[0]

    @property
    def n_items(self) -> int:
        return self._m_items

    def _serve_table(self):
        """The UNPADDED item table, for serving paths that treat every
        column of their operand as a real item (megablock fallback,
        certified). Sliced from the padded device table once, lazily —
        only Recommenders that both pad (reservoir with m % slots != 0)
        and hit a fallback pay the extra copy."""
        if self.H.shape[1] == self._m_items:
            return self.H
        if self._H_unpadded is None:
            self._H_unpadded = self.H[:, :self._m_items]
        return self._H_unpadded

    def user_embedding(self, user_ids) -> np.ndarray:
        return self.W[np.asarray(user_ids)]

    def _exclusion(self, user_ids):
        """Block-bucketed seen lists — O(total_seen), never a (b, m)
        mask, so exclusion stays cheap at the 10M-item scale."""
        if self._train_csr is None:
            return None
        from nmftpu.parallel.mesh import AXIS_ITEMS
        from nmftpu.retrieval.exclusion import build_block_exclusion

        shards = 1
        if self.mesh is not None:
            shards = self.mesh.shape[AXIS_ITEMS]
            if self.n_items % shards != 0:
                raise ValueError(
                    "sharded seen-exclusion requires n_items divisible "
                    "by the items mesh axis; pad H or drop exclude_seen"
                )
        return build_block_exclusion(
            user_ids, self._train_csr, self.n_items, self.block,
            shards=shards,
        )

    def _seen_padded(self, csr: SparseCSR, user_ids, k: int):
        """Padded (b, S) seen-item array for the oversampling exclusion
        form, or None when the batch's widest seen list is too wide for
        oversampling (k + S candidates per block — the scatter-list
        fallback stays cheap there) or exceeds the block width."""
        counts = np.diff(csr.indptr)[user_ids]
        S = int(counts.max()) if counts.size else 0
        cap = (2 * self.reservoir_slots if self.method == "reservoir"
               else self.block)
        if S == 0 or k + S > min(_MAX_OVERSAMPLE_SEEN, cap):
            return None
        return self._seen_full(csr, user_ids, S)

    def _seen_full(self, csr: SparseCSR, user_ids, S: int | None = None):
        """UNCAPPED padded (b, S) seen array — the certify pass's seen
        discount gathers b*S table columns regardless of width, so wide
        seen lists that disqualify oversampling still certify exactly.
        Returns None for an all-empty batch."""
        if S is None:
            counts = np.diff(csr.indptr)[user_ids]
            S = int(counts.max()) if counts.size else 0
        if S == 0:
            return None
        seen = np.full((len(user_ids), S), -1, np.int32)
        for row, u in enumerate(np.asarray(user_ids)):
            lo, hi = csr.indptr[u], csr.indptr[u + 1]
            seen[row, :hi - lo] = csr.indices[lo:hi]
        return seen

    def recommend(self, user_ids, k: int = 100,
                  exclude_seen: bool = True, candidate_k: int | None = None):
        """Top-k items for each user id. Returns (scores, item_ids),
        both (len(user_ids), k). candidate_k tunes the approx path's
        per-block candidate count (k' > k buys back per-block recall).
        When fewer than k candidates exist (heavy user, small catalog)
        the tail slots carry score=-inf with a filler index — filter on
        the score."""
        user_ids = np.atleast_1d(np.asarray(user_ids))
        Wq = self.W[user_ids]

        def run():
            seen = lists = None
            if exclude_seen and self._train_csr is not None:
                # method="exact" prefers the scatter-list form: top_k
                # cost grows with the candidate width k+S, and the scan
                # is already sort-bound. approx/reservoir keep
                # oversampling (it keeps the scan free of scatters).
                if self.method != "exact":
                    seen = self._seen_padded(self._train_csr, user_ids, k)
                if seen is None:
                    lists = self._exclusion(user_ids)
            s, i = self._topk(Wq, k, lists, candidate_k, seen=seen)
            return np.asarray(s), np.asarray(i)  # materialize in-guard

        return self._scan_with_backoff(run)

    def recommend_certified(self, user_ids, k: int = 100,
                            exclude_seen: bool = True,
                            candidate_k: int | None = None,
                            fallback: str | None = None):
        """Like `recommend` but returns (scores, item_ids, certified):
        the approx megablock scan plus a count-above-threshold
        verification pass — certified[u] proves row u IS the exact
        top-k up to ties at the kth score (see
        retrieval.mips.topk_mips_certified).

        fallback="exact": uncertified rows are re-scanned through the
        exact path in ONE composed call, so every returned row is the
        exact top-k (certified still reports which rows needed the
        re-scan — `(~certified).mean()` is the fallback rate).

        Users whose seen list is too wide for oversampling exclusion
        degrade to the scatter-list scan + a wide-seen certify discount
        instead of raising — the certificate stays exact. On a mesh the
        candidates come from the sharded scan and the certificate from
        `parallel.retrieval_sharded.certify_topk_sharded` (per-shard
        compare-reduce counts psum'd over the items axis)."""
        if fallback not in (None, "exact"):
            raise ValueError(
                f"fallback must be None or 'exact', got {fallback!r}"
            )
        user_ids = np.atleast_1d(np.asarray(user_ids))
        Wq = self.W[user_ids]
        scan = (self._certified_scan_sharded if self.mesh is not None
                else self._certified_scan)

        def run():
            seen_os, seen_full, lists = self._certified_exclusion(
                user_ids, k, exclude_seen)
            s, i, cert = scan(Wq, k, candidate_k, seen_os, seen_full,
                              lists)
            # materialize in-guard (async dispatch defers device OOMs)
            return np.asarray(s), np.asarray(i), np.asarray(cert)

        s, i, cert = self._scan_with_backoff(run)
        if fallback == "exact" and not cert.all():
            rows = np.flatnonzero(~cert)
            s, i = s.copy(), i.copy()
            # escalated reservoir pass on just the uncertified rows
            # (4x slots: table-read-bound, ~1/16 the miss rate) —
            # whatever certifies there is proven exact and skips the
            # sort-bound exact scan. GATED on the subset exceeding one
            # exact-scan bucket: tie-boundary rows (an item within an
            # ulp of the kth score) never certify at ANY slot count,
            # so a small subset pays the same one-bucket exact scan
            # either way and escalation would only add its own cost
            if len(rows) > 16:
                rows = self._escalate_rows(s, i, rows, user_ids, k,
                                           exclude_seen)
            if len(rows):
                s2, i2 = self._exact_rows(user_ids[rows], k,
                                          exclude_seen)
                s[rows], i[rows] = s2, i2
        return s, i, cert

    def _escalate_rows(self, s, i, rows, user_ids, k, exclude_seen):
        """One escalated certified pass over a row subset: re-scan with
        4x reservoir_slots (+ rescore + certificate), splice certified
        rows into (s, i) IN PLACE, and return the still-uncertified
        residue. Applies only where the escalated scan reuses the
        resident table zero-copy (single device, reservoir method, the
        padded width divisible by the escalated slot count — a per-call
        pad would copy the multi-GB table); returns `rows` unchanged
        otherwise."""
        # 4x: ~1/16 the per-row miss rate (C(k,3)/slots^2)
        esc = self.reservoir_slots * 4
        if (self.mesh is not None or self.method != "reservoir"
                or self.H.shape[1] % esc != 0):
            return rows
        from nmftpu.kernels.mips_reservoir import reservoir_topk_mips
        from nmftpu.retrieval.mips import certify_topk, rescore_and_sort

        sub_users = user_ids[rows]
        Wq = self.W[sub_users]
        seen_os = None
        if exclude_seen and self._train_csr is not None:
            # build against the ESCALATED oversampling cap (2*esc) —
            # _seen_padded's cap is the base 2*slots, which would skip
            # seen widths the 4x pass can handle
            seen_full = self._seen_full(self._train_csr, sub_users)
            if seen_full is not None:
                if k + seen_full.shape[1] > min(_MAX_OVERSAMPLE_SEEN,
                                                2 * esc):
                    return rows  # truly wide: exact scan handles it
                seen_os = seen_full

        def run():
            s0, i0 = reservoir_topk_mips(
                Wq, self.H, k, slots=esc, seen=seen_os,
                h_scale=self._h_scale, m_items=self._m_items,
            )
            s1, i1 = rescore_and_sort(
                Wq, self._serve_table(), i0, h_scale=self._h_scale,
                invalid=np.asarray(s0) == -np.inf, seen=seen_os,
            )
            cert = certify_topk(
                Wq, self._serve_table(), s1, k, block=self.block,
                h_scale=self._h_scale, seen=seen_os,
            )
            return np.asarray(s1), np.asarray(i1), np.asarray(cert)

        try:
            s1, i1, cert1 = run()
        except Exception as e:  # noqa: BLE001 — filtered by _is_oom
            # the escalation is an optimization: when its wider
            # reservoir exhausts device memory the exact scan below
            # covers the rows; any other failure is a fault and surfaces
            if not _is_oom(e):
                raise
            warnings.warn(
                f"escalated certified pass failed "
                f"({type(e).__name__}); falling back to the exact "
                f"scan for {len(rows)} rows", RuntimeWarning,
                stacklevel=3,
            )
            return rows
        ok = np.flatnonzero(cert1)
        s[rows[ok]], i[rows[ok]] = s1[ok], i1[ok]
        return rows[np.flatnonzero(~cert1)]

    def _certified_exclusion(self, user_ids, k: int,
                             exclude_seen: bool):
        """(seen_os, seen_full, lists) for a certified scan: the capped
        oversample array when the batch fits it, else the UNCAPPED
        certify-discount array plus scatter lists for the candidate
        scan (the wide-seen degrade — exact either way)."""
        seen_os = seen_full = lists = None
        if exclude_seen and self._train_csr is not None:
            seen_os = self._seen_padded(self._train_csr, user_ids, k)
            if seen_os is None:
                seen_full = self._seen_full(self._train_csr, user_ids)
                if seen_full is not None:
                    lists = self._exclusion(user_ids)
        return seen_os, seen_full, lists

    def _certified_scan(self, Wq, k, candidate_k, seen_os, seen_full,
                        lists):
        """Single-device certified candidates + certificate."""
        from nmftpu.retrieval.mips import (
            certify_topk, topk_mips_blocked, topk_mips_certified,
        )

        if lists is not None:
            # wide-seen degrade: candidates from the scatter-list scan;
            # the certify discount gathers the full (b, S) seen columns
            s, i = topk_mips_blocked(
                Wq, self._serve_table(), k, block=self.block,
                exclude_lists=lists, method="approx",
                candidate_k=candidate_k, h_scale=self._h_scale,
            )
            cert = certify_topk(
                Wq, self._serve_table(), s, k, block=self.block,
                h_scale=self._h_scale, seen=seen_full,
            )
            return s, i, cert
        if self.method == "reservoir":
            # candidates from the reservoir scan; the returned ids are
            # re-scored at the certify pass's dtype rules (a tiny b*k
            # column gather) so the kth-score threshold is comparable —
            # the scan's all-bf16 scores sit ~0.4% below the exact
            # scan's and would
            # fail correct rows otherwise. Filler/seen slots (score
            # -inf from the scan) stay -inf through the re-score: at
            # k > available candidates the gather would otherwise
            # revive dropped ids as duplicates.
            from nmftpu.kernels.mips_reservoir import (
                reservoir_topk_mips,
            )
            from nmftpu.retrieval.mips import rescore_and_sort

            if candidate_k is not None:
                warnings.warn(
                    "candidate_k has no effect on the reservoir "
                    "scan — tune reservoir_slots instead",
                    UserWarning, stacklevel=5,
                )
            s0, i = reservoir_topk_mips(
                Wq, self.H, k, slots=self.reservoir_slots,
                seen=seen_os, h_scale=self._h_scale,
                m_items=self._m_items,
            )
            s, i = rescore_and_sort(
                Wq, self._serve_table(), i, h_scale=self._h_scale,
                invalid=np.asarray(s0) == -np.inf, seen=seen_os,
            )
            cert = certify_topk(
                Wq, self._serve_table(), s, k, block=self.block,
                h_scale=self._h_scale, seen=seen_os,
            )
            return s, i, cert
        return topk_mips_certified(
            Wq, self._serve_table(), k, block=self.block,
            candidate_k=candidate_k, h_scale=self._h_scale,
            seen=seen_os,
        )

    def _certified_scan_sharded(self, Wq, k, candidate_k, seen_os,
                                seen_full, lists):
        """Mesh certified candidates + the psum'd per-shard
        certificate. The reservoir merge keeps the kernel's bf16
        scores, so its candidates are re-scored at the certify dtype
        rules first (a b*k column gather — GSPMD reshards it; tiny
        next to the scan)."""
        from nmftpu.parallel.retrieval_sharded import (
            certify_topk_sharded,
        )
        from nmftpu.retrieval.mips import rescore_and_sort

        s, i = self._topk(Wq, k, lists, candidate_k, seen=seen_os)
        if self.method == "reservoir" and lists is None:
            s, i = rescore_and_sort(
                Wq, self.H, i, h_scale=self._h_scale,
                invalid=np.asarray(s) == -np.inf, seen=seen_os,
            )
        cert = certify_topk_sharded(
            Wq, self.H, s, k, mesh=self.mesh, block=self.block,
            h_scale=self._h_scale,
            seen=seen_os if seen_os is not None else seen_full,
        )
        return s, i, cert

    def _exact_rows(self, user_ids, k: int, exclude_seen: bool):
        """Exact top-k for a row subset (the fallback="exact" re-scan):
        sort-bound blocked scan with scatter-list exclusion — the
        measured-faster exclusion form for the exact method. The subset
        is padded to a power-of-two batch (repeating row 0) so repeated
        fallback calls compile one program per size bucket, not one per
        uncertified count."""
        from nmftpu.retrieval.mips import topk_mips_blocked

        user_ids = np.asarray(user_ids)
        nb = len(user_ids)
        cap = 1 << max(3, (nb - 1).bit_length())
        padded = np.concatenate(
            [user_ids, np.full(cap - nb, user_ids[0] if nb else 0,
                               user_ids.dtype)])
        Wq = self.W[padded]

        def run():
            lists = (self._exclusion(padded)
                     if exclude_seen and self._train_csr is not None
                     else None)
            if self.mesh is not None:
                from nmftpu.parallel import topk_mips_sharded

                s, i = topk_mips_sharded(
                    Wq, self.H, k, mesh=self.mesh, block=self.block,
                    exclude_lists=lists, method="exact",
                    h_scale=self._h_scale,
                )
                return np.asarray(s), np.asarray(i)
            s, i = topk_mips_blocked(
                Wq, self._serve_table(), k, block=self.block,
                exclude_lists=lists, method="exact",
                h_scale=self._h_scale,
            )
            return np.asarray(s), np.asarray(i)  # materialize in-guard

        s, i = self._scan_with_backoff(run)
        return s[:nb], i[:nb]

    # -- cold users: fold-in against the frozen item table -----------------

    def fold_in(self, item_ids, values=None, *, algorithm: str = "als",
                objective: str = "frobenius", num_iterations: int = 50,
                alpha_confidence: float = 0.0, lambda_w: float = 1e-6,
                seed: int = 0) -> np.ndarray:
        """Embed a user NOT present at training time from their interaction
        history (``transform`` with this recommender's H frozen). Returns
        the (rank,) nonnegative embedding. ``values`` defaults to implicit
        1.0 per item; ``algorithm="als"`` is a one-shot solve (the serving
        default), ``"mu"`` iterates ``num_iterations`` times."""
        W = self.fold_in_batch([(item_ids, values)], algorithm=algorithm,
                               objective=objective,
                               num_iterations=num_iterations,
                               alpha_confidence=alpha_confidence,
                               lambda_w=lambda_w, seed=seed)
        return W[0]

    def fold_in_batch(self, histories, *, algorithm: str = "als",
                      objective: str = "frobenius",
                      num_iterations: int = 50,
                      alpha_confidence: float = 0.0,
                      lambda_w: float = 1e-6, seed: int = 0) -> np.ndarray:
        """Embed MANY cold users in one device call: the fold-in solve is
        batched (one gathered-columns GEMM / one vmapped r×r solve for
        the whole batch), so per-request overhead is paid once.
        ``histories``: iterable of ``item_ids`` arrays or
        ``(item_ids, values)`` 2-tuples (array-like ids). Returns
        (b, rank)."""
        csr = self._histories_csr(histories)
        return self._fold_in_csr(
            csr, algorithm=algorithm, objective=objective,
            num_iterations=num_iterations,
            alpha_confidence=alpha_confidence, lambda_w=lambda_w,
            seed=seed,
        )

    def _fold_in_csr(self, csr, *, algorithm, objective, num_iterations,
                     alpha_confidence, lambda_w, seed):
        from nmftpu.foldin import transform

        res = transform(
            csr, self._prep(), algorithm=algorithm, objective=objective,
            num_iterations=num_iterations,
            alpha_confidence=alpha_confidence, lambda_w=lambda_w,
            seed=seed,
        )
        return res.W

    def _histories_csr(self, histories):
        """Normalize per-user histories into a (b, n_items) SparseCSR."""
        from nmftpu.sparse import SparseCSR

        ids_list, val_list = [], []
        for h in histories:
            if isinstance(h, tuple):
                # a tuple is the (item_ids, values) pair form — require
                # array-like ids so a plain tuple of item ids cannot be
                # silently misread as one weighted item
                if len(h) != 2 or np.isscalar(h[0]) \
                        or isinstance(h[0], (int, np.integer)):
                    raise ValueError(
                        "a tuple history must be (item_ids, values) "
                        "with array-like item_ids; pass bare ids as a "
                        "list/array, not a tuple"
                    )
                ids, vals = h
            else:
                ids, vals = h, None
            ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
            if vals is None:
                vals = np.ones(len(ids), dtype=np.float32)
            vals = np.atleast_1d(np.asarray(vals, dtype=np.float32))
            if vals.shape != ids.shape:
                raise ValueError("values must match item_ids in length")
            # CSR wants sorted columns per row
            o = np.argsort(ids, kind="stable")
            ids_list.append(ids[o])
            val_list.append(vals[o])
        counts = np.array([len(x) for x in ids_list], dtype=np.int64)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        indices = (np.concatenate(ids_list) if ids_list
                   else np.zeros(0, np.int64))
        data = (np.concatenate(val_list) if val_list
                else np.zeros(0, np.float32))
        return SparseCSR(indptr, indices, data,
                         (len(ids_list), self.n_items))

    def recommend_from_history(self, item_ids, values=None, k: int = 100,
                               exclude_history: bool = True,
                               candidate_k: int | None = None,
                               **fold_in_kwargs):
        """Top-k items for an unseen user described only by their history:
        fold-in embedding + the same blocked MIPS path as `recommend`.
        Returns (scores, item_ids), both shape (k,)."""
        s, i = self.recommend_from_history_batch(
            [(item_ids, values)], k=k, exclude_history=exclude_history,
            candidate_k=candidate_k, **fold_in_kwargs,
        )
        return s[0], i[0]

    def recommend_from_history_batch(self, histories, k: int = 100,
                                     exclude_history: bool = True,
                                     candidate_k: int | None = None,
                                     **fold_in_kwargs):
        """Batched cold-user serving: one fold-in solve + ONE blocked
        top-k scan for the whole batch (b users amortize the table
        read). Returns (scores, item_ids), both (b, k)."""
        # materialize ONCE: `histories` may be a generator, and both the
        # fold-in and the exclusion lists need the same CSR
        csr = self._histories_csr(histories)
        kw = {"algorithm": "als", "objective": "frobenius",
              "num_iterations": 50, "alpha_confidence": 0.0,
              "lambda_w": 1e-6, "seed": 0}
        kw.update(fold_in_kwargs)
        Wq = self._fold_in_csr(csr, **kw)

        def run():
            seen = lists = None
            if exclude_history:
                all_rows = np.arange(csr.shape[0], dtype=np.int64)
                # exact scans prefer scatter lists (see recommend())
                if self.method != "exact":
                    seen = self._seen_padded(csr, all_rows, k)
                if seen is None:
                    from nmftpu.parallel.mesh import AXIS_ITEMS
                    from nmftpu.retrieval.exclusion import (
                        build_block_exclusion,
                    )

                    shards = (self.mesh.shape[AXIS_ITEMS]
                              if self.mesh is not None else 1)
                    lists = build_block_exclusion(
                        all_rows, csr, self.n_items, self.block,
                        shards=shards,
                    )
            s, i = self._topk(np.asarray(Wq, np.float32), k, lists,
                              candidate_k, seen=seen)
            return np.asarray(s), np.asarray(i)  # materialize in-guard

        return self._scan_with_backoff(run)

    def score(self, user_id: int, item_ids) -> np.ndarray:
        """Predicted affinities for specific (user, items) pairs. Gathers
        only the requested table columns ON DEVICE — never a full H
        host copy (10 GB at the 10M-item design point)."""
        import jax.numpy as jnp

        item_ids = np.atleast_1d(np.asarray(item_ids))
        if item_ids.size and (
            item_ids.min() < 0 or item_ids.max() >= self.n_items
        ):
            raise ValueError(
                f"item index out of range for {self.n_items} items"
            )
        cols = jnp.take(self.H, jnp.asarray(item_ids), axis=1)
        cols = np.asarray(cols, dtype=np.float32)
        if self._h_scale is not None:
            cols = cols * np.asarray(self._h_scale).reshape(-1, 1)
        return self.W[user_id] @ cols

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "W.npy"), self.W)
        # H persists f32 (ml_dtypes .npy files are not portable);
        # table_dtype is re-applied at load (int8 dequantizes first so
        # the reload re-quantizes from true values, not quantized ones)
        Hf = np.asarray(self._serve_table()).astype(np.float32)
        if self._h_scale is not None:
            Hf = Hf * np.asarray(self._h_scale).reshape(-1, 1)
        np.save(os.path.join(path, "H.npy"), Hf)
        meta = {"n_users": self.n_users, "n_items": self.n_items,
                "rank": int(self.W.shape[1]),
                "table_dtype": self.table_dtype,
                "method": self.method, "block": int(self.block),
                "reservoir_slots": self.reservoir_slots}
        if self._train_csr is not None:
            np.savez(
                os.path.join(path, "train.npz"),
                indptr=self._train_csr.indptr,
                indices=self._train_csr.indices,
                data=self._train_csr.data,
            )
            meta["has_train"] = True
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, mesh=None) -> "Recommender":
        W = np.load(os.path.join(path, "W.npy"))
        H = np.load(os.path.join(path, "H.npy"))
        meta = {}
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        train = None
        tr_path = os.path.join(path, "train.npz")
        if os.path.exists(tr_path):
            z = np.load(tr_path)
            train = SparseCSR(
                z["indptr"], z["indices"], z["data"],
                (W.shape[0], H.shape[1]),
            )
        return cls(W, H, train=train, mesh=mesh,
                   block=int(meta.get("block", 8192)),
                   method=meta.get("method", "approx"),
                   table_dtype=meta.get("table_dtype", "float32"),
                   reservoir_slots=int(meta.get("reservoir_slots", 4096)))
