"""Gather-based ELL sparse engine (SURVEY.md §7-PR3's padded-row layout).

The chunked-COO path (sparse_ops) is scatter-bound: every nonzero
scatter-adds an r-vector, O(nnz*r) scattered elements. This layout makes
the hot loop gather-only:

* Each row of V is split into SEGMENTS of at most `seg_max` nonzeros, and
  segments are grouped into power-of-two-width BUCKETS (8/32/128/512 wide,
  zero-padded to the bucket width) — the standard answer to power-law row
  lengths (padding waste is bounded by 2x within a bucket).
* A segment's contribution `sum_k v_k * H[:, col_k]` is a pure GATHER plus
  an einsum. Only the (num_segments, r) segment results are scatter-added
  into rows — ~nnz/seg_max + n rows instead of nnz, i.e. orders of
  magnitude less scatter.
* Row-major ELL computes V H^T; the column-major twin (same container
  built on V^T) computes (W^T V)^T. SDDMM gathers both factor slices per
  nonzero, again scatter-free.

All shapes are static per bucket; buckets are a short python loop inside
jit. Device arrays live in a registered pytree so the whole structure
passes through jit/scan unchanged.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from nmftpu import sparse as host_sparse
from nmftpu.linalg import dense as D

# Finer widths cost a few extra kernel launches but cut segment padding
# 1.74x -> 1.44x on ML-20M power-law data (the gather is latency-bound
# per ROW, so padded rows are the bill): measured ~10% per-SpMM win.
DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["vals", "cols", "out_row"],
    meta_fields=["width"],
)
@dataclasses.dataclass(frozen=True)
class EllBucket:
    """Segments of uniform padded width. vals/cols: (nseg, width);
    out_row[s] = destination row of segment s."""

    vals: jax.Array
    cols: jax.Array
    out_row: jax.Array
    width: int


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["buckets"],
    meta_fields=["shape", "nnz"],
)
@dataclasses.dataclass(frozen=True)
class EllRows:
    """Row-segmented ELL of a sparse matrix (for V @ H^T style products)."""

    buckets: tuple
    shape: tuple[int, int]
    nnz: int


def build_ell_rows(
    mat: host_sparse.SparseMatrix,
    dtype=jnp.float32,
    seg_max: int = 512,
    buckets: tuple[int, ...] = DEFAULT_BUCKETS,
    chunk_segments: int = 2048,
) -> EllRows:
    """Host-side builder: CSR -> bucketed padded segments (vectorized —
    O(nnz) numpy, no per-row python loop). Columns within a segment are
    ascending (to_csr lexsorts by (row, col)), which speeds the row
    gather; padding lanes are (col=0, val=0)."""
    csr = mat.to_csr()
    n, m = csr.shape
    assert buckets[-1] >= seg_max

    def _pad_rule(nseg):
        nseg_p = ((nseg + chunk_segments - 1) // chunk_segments) * (
            chunk_segments if nseg > chunk_segments else 1
        )
        return max(nseg_p, nseg)

    # Native fast path (nmio_ell_count/fill — one sequential C++ pass,
    # measured ~10x the vectorized numpy below at 100M nnz): f32 device
    # dtype + f32 CSR data only; large inputs only (ctypes overhead);
    # NMFTPU_NATIVE_CSR=0 disables alongside the CSR fast path.
    import os as _os

    from nmftpu import native_loader

    if (
        jnp.dtype(dtype) == jnp.float32
        and csr.data.dtype == np.float32
        and csr.nnz >= native_loader.NATIVE_MIN_NNZ
        and _os.environ.get("NMFTPU_NATIVE_CSR", "1") != "0"
    ):
        try:
            nat = native_loader.ell_build(
                csr.indptr, csr.indices, csr.data, seg_max, buckets,
                pad_segments=_pad_rule,
            )
        except RuntimeError:
            nat = None
        if nat is not None:
            out = [
                EllBucket(vals=jnp.asarray(v), cols=jnp.asarray(c),
                          out_row=jnp.asarray(r), width=w)
                for v, c, r, _ns, w in nat
            ]
            return EllRows(buckets=tuple(out), shape=(n, m),
                           nnz=csr.nnz)

    indptr = np.asarray(csr.indptr, dtype=np.int64)
    lens = np.diff(indptr)

    # one (row, offset, seg_len) triple per segment, all vectorized
    # (empty rows contribute no segments, as before)
    nseg_row = (lens + seg_max - 1) // seg_max
    seg_row = np.repeat(np.arange(n, dtype=np.int64), nseg_row)
    starts = np.repeat(np.cumsum(nseg_row) - nseg_row, nseg_row)
    k_in_row = np.arange(seg_row.size, dtype=np.int64) - starts
    off = indptr[seg_row] + k_in_row * seg_max
    seg_len = np.minimum(indptr[seg_row + 1] - off, seg_max)

    widths = np.asarray(buckets, dtype=np.int64)
    which = np.searchsorted(widths, seg_len)       # smallest bucket >= len

    nnz_total = int(indptr[-1])
    out = []
    for bi, width in enumerate(buckets):
        sel = np.flatnonzero(which == bi)
        if sel.size == 0:
            continue
        nseg = sel.size
        nseg_p = ((nseg + chunk_segments - 1) // chunk_segments) * (
            chunk_segments if nseg > chunk_segments else 1
        )
        nseg_p = max(nseg_p, nseg)
        pos = off[sel][:, None] + np.arange(width)[None, :]
        valid = np.arange(width)[None, :] < seg_len[sel][:, None]
        pos = np.where(valid, pos, 0).clip(0, max(nnz_total - 1, 0))
        vals = np.zeros((nseg_p, width), dtype=np.dtype(dtype))
        cols = np.zeros((nseg_p, width), dtype=np.int32)
        rows = np.zeros((nseg_p,), dtype=np.int32)
        if nnz_total:
            vals[:nseg] = np.where(valid, csr.data[pos], 0)
            cols[:nseg] = np.where(valid, csr.indices[pos], 0)
        rows[:nseg] = seg_row[sel]
        # out_row must stay non-decreasing through the padding tail so the
        # segment scatter-add can claim indices_are_sorted (pad segments
        # carry zero values — adding them to the last row is a no-op)
        rows[nseg:] = rows[nseg - 1] if nseg else 0
        out.append(EllBucket(
            vals=jnp.asarray(vals), cols=jnp.asarray(cols),
            out_row=jnp.asarray(rows), width=int(width),
        ))
    return EllRows(buckets=tuple(out), shape=(n, m), nnz=csr.nnz)


def _gather_rows(Ht, flat_cols):
    """Axis-0 row gather from a (m, r) table with promise_in_bounds:
    each gathered row is one contiguous r-vector, where `take(H,
    axis=1)` would gather strided columns. Builders keep segment
    columns sorted for locality."""
    return Ht.at[flat_cols].get(
        mode="promise_in_bounds", indices_are_sorted=False
    )


def _acc_dtype(dtype):
    """Accumulate low-precision (bf16 gather_dtype) segments in f32, but
    NEVER truncate a float64 run — the x64 contract (config.resolve_dtype)
    promises no silent downgrade."""
    return jnp.promote_types(dtype, jnp.float32)


def _bucket_rowsums(bucket: EllBucket, Ht, chunk: int):
    """Per-segment sum_k v_k * Ht[col_k, :] -> (nseg, r), scatter-free.
    Ht: the (m, r) ROW-major table (H transposed once by the caller)."""
    r = Ht.shape[1]
    nseg = bucket.vals.shape[0]
    acc = _acc_dtype(Ht.dtype)

    def block(v, c):
        g = _gather_rows(Ht, c.reshape(-1)).astype(acc)
        gv = v.reshape(-1, 1).astype(acc) * g
        return gv.reshape(v.shape[0], bucket.width, r).sum(axis=1)

    if nseg <= chunk:
        return block(bucket.vals, bucket.cols)
    T = (nseg + chunk - 1) // chunk
    pad = T * chunk - nseg
    vals = jnp.pad(bucket.vals, ((0, pad), (0, 0))).reshape(
        T, chunk, bucket.width
    )
    cols = jnp.pad(bucket.cols, ((0, pad), (0, 0))).reshape(
        T, chunk, bucket.width
    )

    _, res = lax.scan(
        lambda _, x: (None, block(x[0], x[1])), None, (vals, cols)
    )
    return res.reshape(T * chunk, r)[:nseg]


def v_ht_ell(ell: EllRows, H, chunk: int = 2048,
             gather_dtype=None) -> jax.Array:
    """V @ H^T -> (n, r). Gathers dominate; the only scatter is the
    per-segment row accumulation (#segments ≈ n + nnz/seg_max).

    gather_dtype optionally down-casts the gathered table."""
    H = jnp.asarray(H)
    Ht = H.T if gather_dtype is None else H.T.astype(gather_dtype)
    n = ell.shape[0]
    r = H.shape[0]
    out = jnp.zeros((n, r), _acc_dtype(Ht.dtype))
    for bucket in ell.buckets:
        seg = _bucket_rowsums(bucket, Ht, chunk)
        # out_row is ascending within a bucket (builder emits segments
        # row-major): let XLA use the sorted-scatter path
        out = out.at[bucket.out_row].add(
            seg, indices_are_sorted=True, mode="promise_in_bounds"
        )
    return out.astype(H.dtype)


def _bucket_sampled_rowsums(bucket: EllBucket, Ht, w_rows, coeff_fns,
                            chunk: int):
    """Fused SDDMM + per-value transform + SpMM for one bucket: gather
    g = Ht[cols] ONCE, sample s_k = <w_row, g_k>, then for each coeff fn
    emit seg_i = Σ_k fn(v, s)_k · g_k  -> (nseg, r).

    This is the KL/weighted hot path: the plain formulation gathers the
    same rows once for the SDDMM and again for the SpMM; fusing halves
    (KL) or thirds (weighted) the gather traffic, which is the measured
    bottleneck. Returns one (nseg, r) array per coeff fn."""
    r = Ht.shape[1]
    nseg, width = bucket.vals.shape
    acc = _acc_dtype(Ht.dtype)

    def block(v, c, wr):
        g = _gather_rows(Ht, c.reshape(-1)).astype(acc)
        g3 = g.reshape(v.shape[0], width, r)
        s = jnp.einsum("sr,skr->sk", wr.astype(acc), g3)
        outs = []
        for fn in coeff_fns:
            coef = fn(v.astype(acc), s)
            outs.append(jnp.einsum(
                "sk,skr->sr", coef, g3,
                preferred_element_type=acc,
            ))
        return tuple(outs)

    if nseg <= chunk:
        return block(bucket.vals, bucket.cols, w_rows)
    T = (nseg + chunk - 1) // chunk
    pad = T * chunk - nseg
    vals = jnp.pad(bucket.vals, ((0, pad), (0, 0))).reshape(
        T, chunk, width
    )
    cols = jnp.pad(bucket.cols, ((0, pad), (0, 0))).reshape(
        T, chunk, width
    )
    wr = jnp.pad(w_rows, ((0, pad), (0, 0))).reshape(
        T, chunk, w_rows.shape[1]
    )
    _, res = lax.scan(
        lambda _, x: (None, block(*x)), None, (vals, cols, wr)
    )
    return tuple(r_.reshape(T * chunk, -1)[:nseg] for r_ in res)


def sampled_rowsums_ell(ell: EllRows, W, H, coeff_fns, chunk: int = 2048):
    """Fused gather-once 'transform(SDDMM) then SpMM' over a whole
    container: for each coeff fn, returns Σ_k fn(v, (WH)_nz)_k · H[:,col_k]
    accumulated into rows -> (n, r). W provides the row vectors sampled
    against the gathered table rows."""
    W = jnp.asarray(W)
    H = jnp.asarray(H)
    Ht = H.T
    n = ell.shape[0]
    r = H.shape[0]
    outs = [jnp.zeros((n, r), _acc_dtype(Ht.dtype)) for _ in coeff_fns]
    for bucket in ell.buckets:
        w_rows = W[bucket.out_row]
        segs = _bucket_sampled_rowsums(bucket, Ht, w_rows, coeff_fns,
                                       chunk)
        outs = [
            o.at[bucket.out_row].add(
                s, indices_are_sorted=True, mode="promise_in_bounds"
            )
            for o, s in zip(outs, segs)
        ]
    return tuple(o.astype(H.dtype) for o in outs)


def sddmm_ell(ell: EllRows, W, H, chunk: int = 2048) -> EllRows:
    """(W H) sampled at the nonzero positions, returned as an EllRows with
    the same structure whose vals are the sampled products (padding lanes
    yield W[row]·H[:,0] garbage but their v=0 partners zero them in use —
    callers only consume these values multiplied by original vals)."""
    W = jnp.asarray(W)
    H = jnp.asarray(H)
    Ht = H.T                                             # (m, r) row table
    new_buckets = []
    for bucket in ell.buckets:
        nseg, width = bucket.vals.shape
        w_rows = W[bucket.out_row]                        # (nseg, r)

        def sample(cols_blk, w_blk):
            g = _gather_rows(Ht, cols_blk.reshape(-1))
            g = g.reshape(cols_blk.shape[0], width, H.shape[0])
            return jnp.einsum("sr,skr->sk", w_blk, g)

        if nseg <= chunk:
            s = sample(bucket.cols, w_rows)
        else:
            T = (nseg + chunk - 1) // chunk
            pad = T * chunk - nseg
            cols = jnp.pad(bucket.cols, ((0, pad), (0, 0))).reshape(
                T, chunk, width
            )
            wr = jnp.pad(w_rows, ((0, pad), (0, 0))).reshape(
                T, chunk, W.shape[1]
            )
            _, s = lax.scan(
                lambda _, x: (None, sample(x[0], x[1])), None, (cols, wr)
            )
            s = s.reshape(T * chunk, width)[:nseg]
        new_buckets.append(EllBucket(
            vals=s, cols=bucket.cols, out_row=bucket.out_row,
            width=width,
        ))
    return EllRows(buckets=tuple(new_buckets), shape=ell.shape,
                   nnz=ell.nnz)


def map_values(ell: EllRows, fn) -> EllRows:
    """Elementwise transform of stored values (padding stays harmless as
    long as fn(0)-lanes are only ever used multiplied by true-value 0)."""
    return EllRows(
        buckets=tuple(
            EllBucket(vals=fn(b.vals), cols=b.cols, out_row=b.out_row,
                      width=b.width)
            for b in ell.buckets
        ),
        shape=ell.shape, nnz=ell.nnz,
    )


def combine_values(a: EllRows, b: EllRows, fn) -> EllRows:
    """Elementwise combine of two structurally identical EllRows."""
    return EllRows(
        buckets=tuple(
            EllBucket(vals=fn(x.vals, y.vals), cols=x.cols,
                      out_row=x.out_row, width=x.width)
            for x, y in zip(a.buckets, b.buckets)
        ),
        shape=a.shape, nnz=a.nnz,
    )


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["rows", "cols"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class EllPair:
    """Row-major ELL of V plus row-major ELL of V^T (= column-major of V):
    everything the MU family needs, gather-only."""

    rows: EllRows      # for V @ H^T
    cols: EllRows      # ELL of V^T, for (W^T V)^T = V^T W

    @property
    def shape(self):
        return self.rows.shape


def build_ell_pair(mat: host_sparse.SparseMatrix, dtype=jnp.float32,
                   **kw) -> EllPair:
    return EllPair(
        rows=build_ell_rows(mat, dtype=dtype, **kw),
        cols=build_ell_rows(mat.T, dtype=dtype, **kw),
    )


def wt_v_ell(pair: EllPair, W, chunk: int = 2048) -> jax.Array:
    """W^T V -> (r, m) via the transposed container: (V^T W)^T."""
    return v_ht_ell(pair.cols, jnp.asarray(W).T, chunk=chunk).T


def mu_update_frobenius_ell(pair: EllPair, W, H, eps=1e-9, order="WH"):
    """Sparse MU (Frobenius) on the gather-only layout."""

    def upd_w(W, H):
        return W * (v_ht_ell(pair.rows, H) / (W @ D.gram_rows(H) + eps))

    def upd_h(W, H):
        return H * (wt_v_ell(pair, W) / (D.gram_cols(W) @ H + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def mu_update_frobenius_weighted_ell(pair: EllPair, W, H, alpha,
                                     eps=1e-9, order="WH"):
    """Confidence-weighted MU (c = 1 + alpha*v at nonzeros) on ELL:
    ONE gather per half-step serves the numerator, the SDDMM sample, and
    the alpha term (fused via sampled_rowsums_ell; the plain form
    gathers the same rows three times)."""
    fns = (
        lambda v, s: v * (1.0 + alpha * v),   # confidence-weighted V
        lambda v, s: v * s,                   # V ⊙ (WH) at nonzeros
    )

    def upd_w(W, H):
        numer, alpha_part = sampled_rowsums_ell(pair.rows, W, H, fns)
        denom = W @ D.gram_rows(H) + alpha * alpha_part + eps
        return W * (numer / denom)

    def upd_h(W, H):
        Wt = jnp.asarray(W).T
        Ht = jnp.asarray(H).T
        numer, alpha_part = sampled_rowsums_ell(pair.cols, Ht, Wt, fns)
        denom = D.gram_cols(W) @ H + alpha * alpha_part.T + eps
        return H * (numer.T / denom)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


_solve_clamped = D.solve_clamped


def als_family_update_ell(
    pair: EllPair, W, H, shift_w=0.0, shift_h=0.0, off_w=0.0, off_h=0.0,
    eps=1e-9, order="WH",
):
    """ALS/ACLS/AHCLS on the gather-only layout: the right-hand sides are
    the two ELL SpMMs, the r×r solves are exact."""

    def upd_w(W, H):
        rhs = v_ht_ell(pair.rows, H).T                    # (r, n)
        return _solve_clamped(D.gram_rows(H), rhs, shift_w, off_w, eps).T

    def upd_h(W, H):
        return _solve_clamped(D.gram_cols(W), wt_v_ell(pair, W), shift_h, off_h,
                              eps)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def gdcls_update_ell(pair: EllPair, W, H, lambda_tik=0.0, eps=1e-9,
                     order="WH"):
    def upd_w(W, H):
        return W * (v_ht_ell(pair.rows, H) / (W @ D.gram_rows(H) + eps))

    def upd_h(W, H):
        return _solve_clamped(D.gram_cols(W), wt_v_ell(pair, W), lambda_tik, 0.0,
                              eps)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def nsnmf_update_kl_ell(pair: EllPair, W, H, S, eps=1e-9, order="WH"):
    """nsNMF under KL on ELL: fused gather-once ratio+SpMM half-steps
    against the smoothed partners (S@H stands in for H, W@S for W)."""
    ratio = (lambda v, s: v / (s + eps),)

    def upd_w(W, H):
        SH = S @ H
        numer, = sampled_rowsums_ell(pair.rows, W, SH, ratio)
        denom = jnp.maximum(jnp.sum(SH, axis=1), eps)[None, :]
        return W * (numer / denom)

    def upd_h(W, H):
        WS = W @ S
        WSt = jnp.asarray(WS).T
        numer, = sampled_rowsums_ell(
            pair.cols, jnp.asarray(H).T, WSt, ratio
        )
        denom = jnp.maximum(jnp.sum(WS, axis=0), eps)[:, None]
        return H * (numer.T / denom)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def nsnmf_update_ell(pair: EllPair, W, H, S, eps=1e-9, order="WH"):
    """nsNMF (Frobenius) on ELL: MU against the smoothed partners."""

    def upd_w(W, H):
        SH = S @ H
        return W * (v_ht_ell(pair.rows, SH) / (W @ D.gram_rows(SH) + eps))

    def upd_h(W, H):
        WS = W @ S
        return H * (wt_v_ell(pair, WS) / (D.gram_cols(WS) @ H + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def sum_v_sq_ell(ell: EllRows) -> jax.Array:
    """||V||_F^2 from the stored (zero-padded) values."""
    return sum(jnp.sum(b.vals * b.vals) for b in ell.buckets)


def frobenius_error_ell(pair: EllPair, W, H, sum_v_sq=None) -> jax.Array:
    """Gram-trick ||V - WH||_F using the gather-only W^T V."""
    if sum_v_sq is None:
        sum_v_sq = sum_v_sq_ell(pair.rows)
    WtV = wt_v_ell(pair, W)
    cross = jnp.sum(WtV * H)
    quad = jnp.sum(D.gram_cols(W) * D.gram_rows(H))
    return jnp.sqrt(jnp.maximum(sum_v_sq - 2.0 * cross + quad, 0.0))


def kl_error_ell(pair: EllPair, W, H, eps=1e-12) -> jax.Array:
    """D_KL(V || WH) with the nonzero log terms sampled via gather-SDDMM."""
    s = sddmm_ell(pair.rows, W, H)
    total = jnp.asarray(0.0, _acc_dtype(jnp.asarray(W).dtype))
    for orig, samp in zip(pair.rows.buckets, s.buckets):
        v = orig.vals
        wh = samp.vals
        term = jnp.where(
            v > 0,
            v * jnp.log(jnp.maximum(v, eps) / jnp.maximum(wh, eps)),
            0.0,
        )
        total = total + jnp.sum(term) - jnp.sum(v)
    return total + jnp.sum(W, axis=0) @ jnp.sum(H, axis=1)


def mu_update_beta_ell(pair: EllPair, W, H, beta, eps=1e-9, order="WH",
                       block=2048):
    """Generalized beta-divergence MU on the gather-only ELL layout
    (beyond-HBM float beta_loss; round-3 verdict item 7): the numerator
    reuses the fused gather-once machinery (sampled_rowsums_ell with
    the coefficient v * WH^(beta-2)), the dense-in-FLOPs denominator
    streams panels via sparse_ops.beta_denom_{w,h}_blocked. Guards /
    gamma / beta<1 stabilization are sklearn's (linalg.dense
    .mu_update_beta is the oracle). ELL padding lanes carry v = 0, so
    their coefficient is 0 * finite (the beta<2 EPSILON clamp keeps the
    sampled-garbage power finite) — exact no-ops."""
    from nmftpu.linalg import dense as D
    from nmftpu.sparse_ops import (beta_denom_h_blocked,
                                   beta_denom_w_blocked)

    gamma = D.beta_gamma(beta)
    W = jnp.asarray(W)
    H = jnp.asarray(H)

    if beta == 0.0:
        def cf(v, s):
            sc = jnp.maximum(s, D.EPSILON)
            return v / (sc * sc)
    elif beta < 2.0:
        def cf(v, s):
            return v * jnp.maximum(s, D.EPSILON) ** (beta - 2.0)
    else:
        def cf(v, s):
            return v * s ** (beta - 2.0)
    coeff = (cf,)

    def stab(X):
        if beta < 1.0:
            return jnp.where(X < D._STAB_EPS, 0.0, X)
        return X

    def apply(F, numer, denom):
        denom = jnp.where(denom == 0.0, D.EPSILON, denom)
        d = numer / denom
        if gamma != 1.0:
            d = d ** gamma
        return stab(F * d)

    def upd_w(W, H):
        numer, = sampled_rowsums_ell(pair.rows, W, H, coeff)
        denom = beta_denom_w_blocked(W, H, beta, block)
        return apply(W, numer, denom)

    def upd_h(W, H):
        numer, = sampled_rowsums_ell(pair.cols, H.T, W.T, coeff)
        denom = beta_denom_h_blocked(W, H, beta, block)
        return apply(H, numer.T, denom)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def beta_divergence_ell(pair: EllPair, W, H, beta, block=2048):
    """D_beta(V || WH) with sklearn's sparse-X semantics on ELL (twin of
    sparse_ops.beta_divergence_sparse; padding lanes carry v = 0 and
    are dropped by the v > EPSILON filter)."""
    from nmftpu.linalg import dense as D
    from nmftpu.sparse_ops import beta_sum_wh_blocked

    s = sddmm_ell(pair.rows, W, H)
    acc_dt = _acc_dtype(jnp.asarray(W).dtype)
    n, m = pair.shape
    sum_x_beta = jnp.asarray(0.0, acc_dt)
    sum_x_wh = jnp.asarray(0.0, acc_dt)
    sum_div = jnp.asarray(0.0, acc_dt)
    sum_log_div = jnp.asarray(0.0, acc_dt)
    for orig, samp in zip(pair.rows.buckets, s.buckets):
        v = orig.vals
        keep = v > D.EPSILON
        wh_c = jnp.maximum(samp.vals, D.EPSILON)
        if beta == 0.0:
            div = (v / wh_c).astype(acc_dt)
            sum_div += jnp.sum(jnp.where(keep, div, 0.0))
            sum_log_div += jnp.sum(jnp.where(
                keep, jnp.log(jnp.where(keep, div, 1.0)), 0.0))
        else:
            sum_x_beta += jnp.sum(jnp.where(
                keep, (v ** beta).astype(acc_dt), 0.0))
            sum_x_wh += jnp.sum(jnp.where(
                keep, (v * wh_c ** (beta - 1.0)).astype(acc_dt), 0.0))
    if beta == 0.0:
        return sum_div - float(n) * float(m) - sum_log_div
    sum_wh_beta = beta_sum_wh_blocked(W, H, beta, block)
    res = sum_x_beta - beta * sum_x_wh + (beta - 1.0) * sum_wh_beta
    return res / (beta * (beta - 1.0))


def mu_update_kl_ell(pair: EllPair, W, H, eps=1e-9, order="WH"):
    """Sparse MU (KL): fused gather-once ratio+SpMM per half-step — the
    table rows are gathered once and reused for the (WH) sample AND the
    numerator SpMM (sampled_rowsums_ell), halving the dominant gather
    traffic vs the separate SDDMM-then-SpMM formulation."""
    ratio = (lambda v, s: v / (s + eps),)

    def upd_w(W, H):
        numer, = sampled_rowsums_ell(pair.rows, W, H, ratio)
        denom = jnp.maximum(jnp.sum(H, axis=1), eps)[None, :]
        return W * (numer / denom)

    def upd_h(W, H):
        # container holds V^T; sample (H^T W^T) = (WH)^T at its nonzeros
        numer, = sampled_rowsums_ell(
            pair.cols, jnp.asarray(H).T, jnp.asarray(W).T, ratio
        )
        denom = jnp.maximum(jnp.sum(W, axis=0), eps)[:, None]
        return H * (numer.T / denom)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


# ---------------------------------------------------------------------------
# Masked (matrix-completion) updates — mask='observed' on the gather-only
# layout. The observed set IS the stored set (a zero-valued observation is
# indistinguishable from unobserved — NmfConfig.mask contract), so the 0/1
# mask is `vals != 0`, which also neutralizes ELL padding lanes for free.
# ---------------------------------------------------------------------------


def mu_update_frobenius_masked_ell(pair: EllPair, W, H, eps=1e-9,
                                   order="WH"):
    """Completion MU under sum_obs (v - wh)^2 on ELL (reference scope:
    SURVEY.md §5.7 long-axis regime; semantics identical to
    sparse_ops.mu_update_frobenius_masked, the scatter oracle):

        W <- W * (V_obs H^T) / ((WH)_obs H^T + eps)

    Fused gather-once: ONE table gather per half-step serves the
    numerator SpMM, the (WH) SDDMM sample, and the masked-denominator
    SpMM (the scatter engine touches the stored set three times)."""
    fns = (
        lambda v, s: v,                              # V_obs
        lambda v, s: jnp.where(v != 0, s, 0.0),      # (WH)_obs
    )

    def upd_w(W, H):
        numer, den = sampled_rowsums_ell(pair.rows, W, H, fns)
        return W * (numer / (den + eps))

    def upd_h(W, H):
        numer, den = sampled_rowsums_ell(
            pair.cols, jnp.asarray(H).T, jnp.asarray(W).T, fns
        )
        return H * (numer.T / (den.T + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def mu_update_kl_masked_ell(pair: EllPair, W, H, eps=1e-9, order="WH"):
    """Masked KL MU on ELL: sum_obs v log(v/wh) - v + wh. Numerator is
    the usual fused ratio SpMM; the denominator is the OBSERVED
    row/column mass of the partner factor (0/1-mask SpMM) instead of the
    full row/column sums — both from the same single gather."""
    fns = (
        lambda v, s: v / (s + eps),                  # ratio
        lambda v, s: (v != 0).astype(s.dtype),       # mask
    )

    def upd_w(W, H):
        numer, den = sampled_rowsums_ell(pair.rows, W, H, fns)
        return W * (numer / (den + eps))

    def upd_h(W, H):
        numer, den = sampled_rowsums_ell(
            pair.cols, jnp.asarray(H).T, jnp.asarray(W).T, fns
        )
        return H * (numer.T / (den.T + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def frobenius_error_masked_ell(pair: EllPair, W, H) -> jax.Array:
    """sqrt(sum_obs (v - wh)^2) — the completion residual (matches
    sparse_ops.frobenius_error_masked)."""
    s = sddmm_ell(pair.rows, W, H)
    total = jnp.asarray(0.0, _acc_dtype(jnp.asarray(W).dtype))
    for orig, samp in zip(pair.rows.buckets, s.buckets):
        resid = jnp.where(orig.vals != 0, orig.vals - samp.vals, 0.0)
        total = total + jnp.sum(resid * resid)
    return jnp.sqrt(total)


def kl_error_masked_ell(pair: EllPair, W, H, eps=1e-12) -> jax.Array:
    """sum_obs v log(v/wh) - v + wh over the observed set only."""
    s = sddmm_ell(pair.rows, W, H)
    total = jnp.asarray(0.0, _acc_dtype(jnp.asarray(W).dtype))
    for orig, samp in zip(pair.rows.buckets, s.buckets):
        v = orig.vals
        wh = jnp.maximum(samp.vals, eps)
        term = v * jnp.log(jnp.maximum(v, eps) / wh) - v + wh
        total = total + jnp.sum(jnp.where(v != 0, term, 0.0))
    return total


# ---------------------------------------------------------------------------
# Per-row weighted Grams on ELL — the iALS / masked-ALS hot path.
#
# The scatter-COO formulation scatters one (r, r) outer product PER
# NONZERO into the (n, r, r) accumulator (nnz * 16 KB at r=64 — 87 GB of
# scatter traffic at ML-20M shape). Here
# each bucket's Gram contributions are ONE batched GEMM over the
# gathered rows — (nseg, r, w) x (nseg, w, r) — and only the (nseg, r, r)
# SEGMENT results are scattered (nseg ~ n + nnz/seg_max), cutting the
# scatter traffic by ~the mean row length.
# ---------------------------------------------------------------------------


def _bucket_grams_rhs(bucket: EllBucket, Ht, weight_fn, value_fn, chunk):
    """Per-segment (Σ_k wgt_k t_k t_kᵀ, Σ_k val_k t_k) from ONE gather."""
    r = Ht.shape[1]
    nseg, width = bucket.vals.shape
    acc = _acc_dtype(Ht.dtype)

    def block(v, c):
        g = _gather_rows(Ht, c.reshape(-1)).astype(acc)
        g3 = g.reshape(v.shape[0], width, r)
        wgt = weight_fn(v).astype(acc)                     # (s, w)
        gram = jnp.einsum(
            "sk,skr,skq->srq", wgt, g3, g3,
            preferred_element_type=acc,
        )
        rhs = jnp.einsum(
            "sk,skr->sr", value_fn(v).astype(acc), g3,
            preferred_element_type=acc,
        )
        return gram, rhs

    if nseg <= chunk:
        return block(bucket.vals, bucket.cols)
    T = (nseg + chunk - 1) // chunk
    pad = T * chunk - nseg
    vals = jnp.pad(bucket.vals, ((0, pad), (0, 0))).reshape(
        T, chunk, width
    )
    cols = jnp.pad(bucket.cols, ((0, pad), (0, 0))).reshape(
        T, chunk, width
    )
    _, (grams, rhss) = lax.scan(
        lambda _, x: (None, block(*x)), None, (vals, cols)
    )
    return (grams.reshape(T * chunk, r, r)[:nseg],
            rhss.reshape(T * chunk, r)[:nseg])


def grams_and_rhs_ell(ell: EllRows, Ht, weight_fn, value_fn,
                      chunk: int = 1024):
    """((n, r, r), (n, r)) f32: per-row Σ weight(v)·t tᵀ and Σ value(v)·t
    over the stored set. Ht is the (m, r) row-major table (H.T for the
    W half, W for the H half on the transposed container). Padding lanes
    hold v = 0, so any weight/value with f(0) = 0 drops them."""
    Ht = jnp.asarray(Ht)
    n = ell.shape[0]
    r = Ht.shape[1]
    acc = _acc_dtype(Ht.dtype)
    grams = jnp.zeros((n, r, r), acc)
    rhs = jnp.zeros((n, r), acc)
    for bucket in ell.buckets:
        gseg, rseg = _bucket_grams_rhs(bucket, Ht, weight_fn, value_fn,
                                       chunk)
        grams = grams.at[bucket.out_row].add(
            gseg, indices_are_sorted=True, mode="promise_in_bounds"
        )
        rhs = rhs.at[bucket.out_row].add(
            rseg, indices_are_sorted=True, mode="promise_in_bounds"
        )
    return grams.astype(jnp.float32), rhs.astype(jnp.float32)


def als_update_weighted_ell_exact(pair: EllPair, W, H, alpha,
                                  lambda_w=0.0, lambda_h=0.0, eps=1e-9,
                                  order="WH", solver="exact",
                                  cg_steps=3):
    """Exact iALS on the gather-only layout (same math as
    sparse_ops.als_update_weighted_sparse, the scatter oracle): per-row
    weighted normal equations

        (H Hᵀ + Σ_{i∈u} αv_ui h_i h_iᵀ + (λ+eps)I) w_u = H (c_u ⊙ v_u)

    with the Gram deltas AND right-hand sides built bucket-wise from one
    gather (grams_and_rhs_ell) — batched GEMMs + segment-level
    scatter instead of per-nonzero (r, r) scatters."""
    from nmftpu.sparse_ops import _row_solver

    W = jnp.asarray(W)
    H = jnp.asarray(H)
    w_fn = lambda v: alpha * v                     # noqa: E731
    cv_fn = lambda v: v * (1.0 + alpha * v)        # noqa: E731
    solve = _row_solver(solver, cg_steps)

    def upd_w(W, H):
        G = D.gram_rows(H).astype(jnp.float32)
        dG, rhs = grams_and_rhs_ell(pair.rows, H.T, w_fn, cv_fn)
        Wn = solve(G[None] + dG, rhs, lambda_w, eps, W)
        return Wn.astype(W.dtype)

    def upd_h(W, H):
        G = D.gram_cols(W).astype(jnp.float32)
        dG, rhs = grams_and_rhs_ell(pair.cols, W, w_fn, cv_fn)
        Hn = solve(G[None] + dG, rhs, lambda_h, eps, H.T)
        return Hn.T.astype(H.dtype)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def als_update_masked_ell(pair: EllPair, W, H, lambda_w=0.0,
                          lambda_h=0.0, eps=1e-9, order="WH",
                          solver="exact", cg_steps=3):
    """Exact completion ALS on ELL: observed-only normal equations per
    row (0/1 indicator weight, NO base Gram — unobserved entries carry
    zero weight), batched Cholesky + clamp. Semantics identical to
    sparse_ops.als_update_masked_sparse."""
    from nmftpu.sparse_ops import _row_solver

    W = jnp.asarray(W)
    H = jnp.asarray(H)
    ind = lambda v: (v != 0)                       # noqa: E731
    val = lambda v: v                              # noqa: E731
    solve = _row_solver(solver, cg_steps)

    def upd_w(W, H):
        dG, rhs = grams_and_rhs_ell(pair.rows, H.T, ind, val)
        Wn = solve(dG, rhs, lambda_w, eps, W)
        return Wn.astype(W.dtype)

    def upd_h(W, H):
        dG, rhs = grams_and_rhs_ell(pair.cols, W, ind, val)
        Hn = solve(dG, rhs, lambda_h, eps, H.T)
        return Hn.T.astype(H.dtype)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H
