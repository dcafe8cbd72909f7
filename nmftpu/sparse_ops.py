"""Device-side sparse NMF (SURVEY.md C11, C13, §7-PR3).

Design: instead of CSR gather loops (the reference's cuSPARSE csrmm
path), nonzeros live in a zero-padded, row-sorted COO layout
(`DeviceCOO`) processed in fixed-size chunks under `lax.scan` — static
shapes throughout, so XLA can pipeline the gathers/scatter-adds. Padding entries carry value 0 and indices 0, making them exact
no-ops in every primitive.

Primitives (all O(nnz * r)):
  wt_v(coo, W)        -> W^T V   (r, m)     [scatter-add over columns]
  v_ht(coo, H)        -> V H^T   (n, r)     [scatter-add over rows]
  sddmm(coo, W, H)    -> (W H) sampled at the nonzero positions  (N,)

Every algorithm of the dense path also runs sparse (the reference
restricted sparse V to the MU family; here the ALS-family right-hand sides
are the same two SpMMs, so all six algorithms are supported).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from nmftpu.config import (
    resolve_dtype,
    Algorithm,
    Initialization,
    NmfConfig,
    Objective,
)
from nmftpu.linalg import dense as D
from nmftpu.loop import LoopOps, NmfResult, build_runner, execute
from nmftpu import backend
from nmftpu import sparse as host_sparse

# Default nonzero-chunk size for the scan pipeline. 128k nonzeros * r=128
# floats is a 64 MB gather per step at f32 — large enough to keep the VPU
# busy, small enough to double-buffer.
DEFAULT_CHUNK = 131072


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["values", "rows", "cols"],
    meta_fields=["shape", "nnz", "chunk"],
)
@dataclasses.dataclass(frozen=True)
class DeviceCOO:
    """Padded, row-sorted COO on device. Padding: value 0, row/col 0."""

    values: jax.Array  # (N,) padded to a multiple of `chunk`
    rows: jax.Array    # (N,) int32
    cols: jax.Array    # (N,) int32
    shape: tuple[int, int]
    nnz: int           # true nonzero count (static)
    chunk: int         # static chunk size

    @property
    def n_chunks(self) -> int:
        return self.values.shape[0] // self.chunk

    def with_values(self, values) -> "DeviceCOO":
        return DeviceCOO(
            values=values, rows=self.rows, cols=self.cols,
            shape=self.shape, nnz=self.nnz, chunk=self.chunk,
        )


def device_put_sparse(
    mat: host_sparse.SparseMatrix,
    dtype=jnp.float32,
    chunk: int = DEFAULT_CHUNK,
) -> DeviceCOO:
    """Upload a host sparse container as padded row-sorted DeviceCOO."""
    csr = mat.to_csr()  # row-major ordering gives locality in the row gather
    coo = csr.to_coo()
    nnz = coo.nnz
    chunk = int(min(chunk, max(256, 1 << (nnz - 1).bit_length())))
    padded = ((nnz + chunk - 1) // chunk) * chunk if nnz else chunk
    values = np.zeros(padded, dtype=np.dtype(dtype))
    rows = np.zeros(padded, dtype=np.int32)
    cols = np.zeros(padded, dtype=np.int32)
    values[:nnz] = coo.data
    rows[:nnz] = coo.row
    cols[:nnz] = coo.col
    return DeviceCOO(
        values=jnp.asarray(values),
        rows=jnp.asarray(rows),
        cols=jnp.asarray(cols),
        shape=coo.shape,
        nnz=nnz,
        chunk=chunk,
    )


# ---------------------------------------------------------------------------
# Chunked primitives
# ---------------------------------------------------------------------------


def _chunked(coo: DeviceCOO):
    T = coo.n_chunks
    return (
        coo.values.reshape(T, coo.chunk),
        coo.rows.reshape(T, coo.chunk),
        coo.cols.reshape(T, coo.chunk),
    )


def _scatter_acc_dtype(dtype):
    """Scatter-add accumulators must not run at bf16: thousands of
    contributions per row/column vanish below the running sum's ulp.
    Accumulate at >= f32 (f64 stays f64 — the x64 contract)."""
    return jnp.promote_types(dtype, jnp.float32)


def wt_v(coo: DeviceCOO, W) -> jax.Array:
    """W^T V -> (r, m): scatter v_k * W[row_k, :] into column col_k."""
    W = jnp.asarray(W)
    m = coo.shape[1]
    r = W.shape[1]
    acc_dt = _scatter_acc_dtype(W.dtype)

    def body(acc, x):
        v, rr, cc = x
        contrib = v[:, None] * W[rr]            # (chunk, r) row gather
        return acc.at[cc].add(contrib.astype(acc_dt)), None

    acc0 = jnp.zeros((m, r), acc_dt)
    acc, _ = lax.scan(body, acc0, _chunked(coo))
    return acc.T.astype(W.dtype)


def v_ht(coo: DeviceCOO, H) -> jax.Array:
    """V H^T -> (n, r): scatter v_k * H[:, col_k] into row row_k."""
    H = jnp.asarray(H)
    n = coo.shape[0]
    r = H.shape[0]
    acc_dt = _scatter_acc_dtype(H.dtype)

    def body(acc, x):
        v, rr, cc = x
        contrib = v[:, None] * H[:, cc].T       # (chunk, r) col gather
        return acc.at[rr].add(contrib.astype(acc_dt)), None

    acc0 = jnp.zeros((n, r), acc_dt)
    acc, _ = lax.scan(body, acc0, _chunked(coo))
    return acc.astype(H.dtype)


def sddmm(coo: DeviceCOO, W, H) -> jax.Array:
    """(W H) sampled at the nonzero coordinates -> (N,) padded values."""
    W = jnp.asarray(W)
    H = jnp.asarray(H)

    def body(_, x):
        _, rr, cc = x
        s = jnp.sum(W[rr] * H[:, cc].T, axis=1)  # (chunk,)
        return None, s

    _, out = lax.scan(body, None, _chunked(coo))
    return out.reshape(-1)


def project_columns(coo: DeviceCOO, weights) -> jax.Array:
    """V @ A for a dense (m, k) column-mixing matrix A -> (n, k).

    Used by MeanColumns init (A = column-sampling averages) and by k-means
    centroid updates (A = one-hot assignments / counts)."""
    return v_ht(coo, weights.T)


# ---------------------------------------------------------------------------
# Sparse error metrics (SURVEY.md C9)
# ---------------------------------------------------------------------------


def frobenius_error(coo: DeviceCOO, W, H, sum_v_sq=None) -> jax.Array:
    """||V - WH||_F over ALL nm entries via the Gram/trace identity.

    sum_v_sq - 2 tr(H^T (W^T V)) + tr((W^T W)(H H^T)); the only
    nnz-dependent term is the sparse W^T V."""
    if sum_v_sq is None:
        vv = coo.values.astype(_scatter_acc_dtype(coo.values.dtype))
        sum_v_sq = jnp.sum(vv * vv)
    WtV = wt_v(coo, W)
    cross = jnp.sum(WtV * H)
    quad = jnp.sum(D.gram_cols(W) * D.gram_rows(H))
    return jnp.sqrt(jnp.maximum(sum_v_sq - 2.0 * cross + quad, 0.0))


def kl_error(coo: DeviceCOO, W, H, eps=1e-12) -> jax.Array:
    """D_KL(V || WH) = sum_nz v log(v / WH) - sum v + sum WH.

    sum WH = (column-sums of W) . (row-sums of H) — no dense materialization;
    only the nonzero positions need the sampled WH (SDDMM)."""
    wh_nz = sddmm(coo, W, H)
    v = coo.values
    log_term = jnp.where(
        v > 0,
        v * jnp.log(jnp.maximum(v, eps) / jnp.maximum(wh_nz, eps)),
        0.0,
    )
    sum_wh = jnp.sum(W, axis=0) @ jnp.sum(H, axis=1)
    return jnp.sum(log_term) - jnp.sum(v) + sum_wh


# ---------------------------------------------------------------------------
# Sparse update rules
# ---------------------------------------------------------------------------


def mu_update_frobenius_sparse(coo, W, H, eps=1e-9, order="WH"):
    """Sparse MU (Frobenius): numerators are SpMMs, denominators Gram GEMMs."""

    def upd_w(W, H):
        return W * (v_ht(coo, H) / (W @ D.gram_rows(H) + eps))

    def upd_h(W, H):
        return H * (wt_v(coo, W) / (D.gram_cols(W) @ H + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def mu_update_kl_sparse(coo, W, H, eps=1e-9, order="WH"):
    """Sparse MU (KL): the ratio V/(WH) is nonzero only at V's nonzeros, so
    one SDDMM + one SpMM per half-step; denominators are factor sums."""

    def upd_w(W, H):
        ratio = coo.with_values(coo.values / (sddmm(coo, W, H) + eps))
        denom = jnp.maximum(jnp.sum(H, axis=1), eps)[None, :]
        return W * (v_ht(ratio, H) / denom)

    def upd_h(W, H):
        ratio = coo.with_values(coo.values / (sddmm(coo, W, H) + eps))
        denom = jnp.maximum(jnp.sum(W, axis=0), eps)[:, None]
        return H * (wt_v(ratio, W) / denom)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def _beta_pwr_d(WH, beta):
    """Denominator power of one beta-MU half-step, sklearn's guard:
    clamp WH up to EPSILON only when beta < 1 (see linalg.dense
    ._beta_powers; the numerator's separate guard lives with the
    SDDMM-sampled values below)."""
    WH_d = jnp.maximum(WH, D.EPSILON) if beta < 1.0 else WH
    return WH_d ** (beta - 1.0)


def beta_denom_w_blocked(W, H, beta, block=2048):
    """(WH)^(beta-1) H^T -> (n, r) via a lax.scan over column panels of
    H: the beta-MU W denominator is DENSE regardless of V's sparsity
    (the power does not factor like beta=2's W(HH^T) or beta=1's row
    sums), but it never needs the full (n, m) matrix — peak memory is
    one (n, block) panel. Zero-pad columns contribute nothing: the
    panel's H^T rows are zero there."""
    W = jnp.asarray(W)
    H = jnp.asarray(H)
    r, m = H.shape
    nb = -(-m // block)
    Hp = jnp.pad(H, ((0, 0), (0, nb * block - m)))
    Hb = Hp.reshape(r, nb, block).transpose(1, 0, 2)      # (nb, r, blk)

    def body(acc, Hblk):
        WH = W @ Hblk                                      # (n, blk)
        return acc + _beta_pwr_d(WH, beta) @ Hblk.T, None

    acc0 = jnp.zeros((W.shape[0], r), W.dtype)
    acc, _ = lax.scan(body, acc0, Hb)
    return acc


def beta_denom_h_blocked(W, H, beta, block=2048):
    """W^T (WH)^(beta-1) -> (r, m) via row panels of W (twin of
    beta_denom_w_blocked; zero-pad rows likewise drop out)."""
    W = jnp.asarray(W)
    H = jnp.asarray(H)
    n, r = W.shape
    nb = -(-n // block)
    Wp = jnp.pad(W, ((0, nb * block - n), (0, 0)))
    Wb = Wp.reshape(nb, block, r)

    def body(acc, Wblk):
        WH = Wblk @ H                                      # (blk, m)
        return acc + Wblk.T @ _beta_pwr_d(WH, beta), None

    acc0 = jnp.zeros((r, H.shape[1]), H.dtype)
    acc, _ = lax.scan(body, acc0, Wb)
    return acc


def beta_sum_wh_blocked(W, H, beta, block=2048):
    """sum over ALL nm entries of (WH)^beta, blockwise (the only term of
    the sparse beta divergence that touches the zero positions). Pad
    columns are masked explicitly: for beta < 0 their 0^beta would be
    +inf, which jnp.where drops (select, not multiply)."""
    W = jnp.asarray(W)
    H = jnp.asarray(H)
    r, m = H.shape
    nb = -(-m // block)
    Hp = jnp.pad(H, ((0, 0), (0, nb * block - m)))
    Hb = Hp.reshape(r, nb, block).transpose(1, 0, 2)
    acc_dt = _scatter_acc_dtype(W.dtype)
    col = jnp.arange(block)

    def body(carry, Hblk):
        acc, i = carry
        WH = (W @ Hblk).astype(acc_dt)
        valid = (i * block + col) < m
        term = jnp.where(valid[None, :], WH ** beta, 0.0)
        return (acc + jnp.sum(term), i + 1), None

    (acc, _), _ = lax.scan(body, (jnp.asarray(0.0, acc_dt), 0), Hb)
    return acc


def _beta_numer_values(coo, W, H, beta, wh_nz=None):
    """values * WH^(beta-2) sampled at the nonzeros — the whole beta-MU
    numerator weight (sklearn's separate numerator guard: clamp WH up
    to EPSILON when beta < 2). This is the part that is pure gathered-
    dot-product work, shared with the KL path's machinery."""
    if wh_nz is None:
        wh_nz = sddmm(coo, W, H)
    wh_n = jnp.maximum(wh_nz, D.EPSILON) if beta < 2.0 else wh_nz
    if beta == 0.0:
        pwr = 1.0 / (wh_n * wh_n)
    else:
        pwr = wh_n ** (beta - 2.0)
    return coo.with_values(coo.values * pwr)


def mu_update_beta_sparse(coo, W, H, beta, eps=1e-9, order="WH",
                          block=2048):
    """Generalized beta-divergence MU on the scatter engine — the
    beyond-HBM route for float beta_loss (round-3 verdict item 7).

    Numerator: (WH)^(beta-2) . V is nonzero only at V's stored set, so
    it is one SDDMM + one scatter-SpMM per half-step — the same fused
    gather machinery as KL. Denominator: (WH)^(beta-1) H^T is dense in
    FLOPs (O(nmr), unavoidable for general beta) but streamed through
    (n, block) panels, never materializing nm. Guards, gamma exponent
    and beta<1 stabilization are sklearn's, guard-for-guard (see
    linalg.dense.mu_update_beta, the dense oracle). `eps` accepted for
    registry-signature uniformity but unused — the guards are the
    fixed EPSILON clamps."""
    gamma = D.beta_gamma(beta)
    W = jnp.asarray(W)
    H = jnp.asarray(H)

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
        ratio = _beta_numer_values(coo, W, H, beta)
        numer = v_ht(ratio, H)
        denom = beta_denom_w_blocked(W, H, beta, block)
        return apply(W, numer, denom)

    def upd_h(W, H):
        ratio = _beta_numer_values(coo, W, H, beta)
        numer = wt_v(ratio, W)
        denom = beta_denom_h_blocked(W, H, beta, block)
        return apply(H, numer, denom)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def beta_divergence_sparse(coo, W, H, beta, block=2048):
    """D_beta(V || WH) with sklearn's sparse-X semantics, guard-for-
    guard (_beta_divergence's sparse branch): stored values filtered to
    v > EPSILON, sampled WH clamped up to EPSILON, and the one term
    that touches the zero positions — sum (WH)^beta — computed
    blockwise over all nm entries (beta=0's version of that term is
    the constant nm)."""
    wh = sddmm(coo, W, H)
    v = coo.values
    keep = v > D.EPSILON
    wh_c = jnp.maximum(wh, D.EPSILON)
    acc_dt = _scatter_acc_dtype(jnp.asarray(W).dtype)
    n, m = coo.shape
    if beta == 0.0:
        div = (v / wh_c).astype(acc_dt)
        return (
            jnp.sum(jnp.where(keep, div, 0.0))
            - float(n) * float(m)
            - jnp.sum(jnp.where(keep, jnp.log(jnp.where(keep, div, 1.0)),
                                0.0))
        )
    sum_wh_beta = beta_sum_wh_blocked(W, H, beta, block)
    sum_x_wh = jnp.sum(jnp.where(
        keep, (v * wh_c ** (beta - 1.0)).astype(acc_dt), 0.0
    ))
    sum_x_beta = jnp.sum(jnp.where(keep, (v ** beta).astype(acc_dt), 0.0))
    res = sum_x_beta - beta * sum_x_wh + (beta - 1.0) * sum_wh_beta
    return res / (beta * (beta - 1.0))


def mu_update_frobenius_weighted_sparse(coo, W, H, alpha, eps=1e-9,
                                        order="WH"):
    """Implicit-feedback confidence weighting c = 1 + alpha*v on observed
    entries, weight 1 elsewhere (BASELINE.json config #3). The dense-part
    denominators stay Gram GEMMs; the alpha-part is SDDMM + SpMM.

      H <- H * (W^T(C*V)) / ((W^T W)H + alpha * W^T(V * WH|_nz) + eps)
    """
    cv = coo.with_values(coo.values * (1.0 + alpha * coo.values))

    def upd_w(W, H):
        swh = coo.with_values(coo.values * sddmm(coo, W, H))
        denom = W @ D.gram_rows(H) + alpha * v_ht(swh, H) + eps
        return W * (v_ht(cv, H) / denom)

    def upd_h(W, H):
        swh = coo.with_values(coo.values * sddmm(coo, W, H))
        denom = D.gram_cols(W) @ H + alpha * wt_v(swh, W) + eps
        return H * (wt_v(cv, W) / denom)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def _obs_mask(coo: DeviceCOO):
    """0/1 observation indicator at the stored coordinates. The chunked
    layout pads with zero VALUES at (0, 0), so `values != 0` is exactly
    the valid-entry mask (a zero-valued observation is indistinguishable
    from unobserved — documented in NmfConfig.mask)."""
    return coo.with_values(
        (coo.values != 0).astype(coo.values.dtype)
    )


def mu_update_frobenius_masked(coo, W, H, eps=1e-9, order="WH"):
    """Matrix-completion MU under sum_obs (v - wh)^2 (Zhang et al.,
    "NMF with missing data"): the numerator is the plain observed SpMM
    and the denominator replaces the dense Gram term with the SDDMM of
    WH restricted to the observed set —

        W <- W * (V_obs H^T) / ((WH)_obs H^T + eps)

    Unobserved entries exert NO pull toward zero (unlike mask='none',
    where they are data)."""
    mask = _obs_mask(coo)

    def upd_w(W, H):
        wh = coo.with_values(mask.values * sddmm(coo, W, H))
        return W * (v_ht(coo, H) / (v_ht(wh, H) + eps))

    def upd_h(W, H):
        wh = coo.with_values(mask.values * sddmm(coo, W, H))
        return H * (wt_v(coo, W) / (wt_v(wh, W) + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def mu_update_kl_masked(coo, W, H, eps=1e-9, order="WH"):
    """Masked KL MU: sum_obs v log(v/wh) - v + wh. The ratio SDDMM is
    the usual sparse-KL numerator; the denominator is the OBSERVED
    row/column mass of the partner factor (SpMM of the 0/1 mask)
    instead of the full row/column sums."""
    mask = _obs_mask(coo)

    def upd_w(W, H):
        ratio = coo.with_values(
            coo.values / (sddmm(coo, W, H) + eps)
        )
        return W * (v_ht(ratio, H) / (v_ht(mask, H) + eps))

    def upd_h(W, H):
        ratio = coo.with_values(
            coo.values / (sddmm(coo, W, H) + eps)
        )
        return H * (wt_v(ratio, W) / (wt_v(mask, W) + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def frobenius_error_masked(coo, W, H):
    """sqrt(sum_obs (v - wh)^2) — the completion objective's residual
    (NOT the full-matrix Frobenius error)."""
    m = (coo.values != 0).astype(jnp.float32)
    resid = m * (
        coo.values.astype(jnp.float32) - sddmm(coo, W, H)
    )
    return jnp.sqrt(jnp.sum(resid * resid))


def kl_error_masked(coo, W, H, eps=1e-12):
    """sum_obs v log(v/wh) - v + wh over the observed set."""
    m = coo.values != 0
    v = coo.values.astype(jnp.float32)
    wh = jnp.maximum(sddmm(coo, W, H), eps)
    term = v * jnp.log(jnp.maximum(v, eps) / wh) - v + wh
    return jnp.sum(jnp.where(m, term, 0.0))


_solve_clamped = D.solve_clamped


def als_family_update_sparse(
    coo, W, H, shift_w=0.0, shift_h=0.0, off_w=0.0, off_h=0.0,
    eps=1e-9, order="WH",
):
    """Shared ALS/ACLS/AHCLS sparse iteration: normal equations with the
    sparse right-hand sides W^T V / V H^T, diagonal (+optional AHCLS
    off-diagonal) shifts, then clamp."""
    def upd_w(W, H):
        Wt = _solve_clamped(D.gram_rows(H), v_ht(coo, H).T, shift_w, off_w, eps)
        return Wt.T

    def upd_h(W, H):
        return _solve_clamped(D.gram_cols(W), wt_v(coo, W), shift_h, off_h, eps)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def _weighted_row_grams(coo, Ht32, alpha, n_rows, by_cols=False,
                        sub=4096, weight_fn=None):
    """(n_rows, r, r) f32: per-row Σ_nz w(v) · t_c t_cᵀ from the gathered
    table rows (t = H column / W row). The sparse-aware iALS Gram delta:
    only the OBSERVED entries carry c−1 = αv, so the cost is O(nnz·r²)
    instead of the dense O(n·m·r²). Outer products run in `sub`-sized
    slices so the (sub, r, r) intermediate stays bounded.

    weight_fn overrides the per-entry weight (default αv — iALS);
    masked completion ALS passes the 0/1 indicator `v != 0` (padding
    slots hold v = 0, so they contribute nothing under either form)."""
    if weight_fn is None:
        weight_fn = lambda v: alpha * v  # noqa: E731
    r = Ht32.shape[1]
    acc0 = jnp.zeros((n_rows, r, r), jnp.float32)
    sub = min(sub, coo.chunk)
    T, tail = divmod(coo.chunk, sub)  # chunk is any 256-multiple — the
    # tail slice must be processed too or its nonzeros silently vanish

    def body(acc, x):
        v, rr, cc = x
        idx, tbl = (cc, rr) if by_cols else (rr, cc)

        def piece(start, size, acc):
            sl = lambda a: lax.dynamic_slice_in_dim(a, start, size, 0)
            t = Ht32[sl(tbl)]                                 # (size, r)
            w = weight_fn(sl(v)).astype(jnp.float32)
            outer = jnp.einsum("k,kr,kq->krq", w, t, t)
            return acc.at[sl(idx)].add(outer)

        acc = lax.fori_loop(
            0, T, lambda i, a: piece(i * sub, sub, a), acc
        )
        if tail:
            acc = piece(T * sub, tail, acc)
        return acc, None

    acc, _ = lax.scan(body, acc0, _chunked(coo))
    return acc


def _row_solver(solver, cg_steps):
    """exact batched Cholesky vs warm-started PCG (see
    linalg.dense._batched_solve_clamped_cg for the receipts)."""
    if solver == "cg":
        return lambda Gb, rhs, lam, eps, x0: D._batched_solve_clamped_cg(
            Gb, rhs, lam, eps, x0, steps=cg_steps
        )
    return lambda Gb, rhs, lam, eps, x0: D._batched_solve_clamped(
        Gb, rhs, lam, eps
    )


def als_update_weighted_sparse(coo, W, H, alpha, lambda_w=0.0,
                               lambda_h=0.0, eps=1e-9, order="WH",
                               solver="exact", cg_steps=3):
    """Sparse-aware confidence-weighted ALS (iALS): minimizes
    ‖√C ⊙ (V − WH)‖² + λ‖·‖² with C = 1 + αV, like
    `mu_update_frobenius_weighted`, but each half-step solves every
    row's exact weighted normal equations

        (H Hᵀ + Σ_{i∈u} αv_ui h_i h_iᵀ + (λ+eps)I) w_u = H (c_u ⊙ v_u)

    Unobserved entries have c = 1, so they contribute only through the
    shared Gram — the classic implicit-feedback shortcut: O(nnz·r²) for
    the Gram deltas + O((n+m)·r³) for the batched Cholesky solves.

    Memory: the per-row Gram deltas materialize (n, r, r) + (m, r, r)
    f32 (panel-free v1) — e.g. 2.3 GB at n=138k, r=64. The driver
    validates this against NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES.
    """
    n, m = coo.shape
    W = jnp.asarray(W)
    H = jnp.asarray(H)
    r = W.shape[1]
    solve = _row_solver(solver, cg_steps)

    def upd_w(W, H):
        Ht32 = H.T.astype(jnp.float32)
        G = D.gram_rows(H).astype(jnp.float32)
        dG = _weighted_row_grams(coo, Ht32, alpha, n)
        cv = coo.with_values(coo.values * (1.0 + alpha * coo.values))
        rhs = v_ht(cv, H).astype(jnp.float32)              # (n, r)
        Wn = solve(G[None] + dG, rhs, lambda_w, eps, W)
        return Wn.astype(W.dtype)

    def upd_h(W, H):
        W32 = W.astype(jnp.float32)
        G = D.gram_cols(W).astype(jnp.float32)
        dG = _weighted_row_grams(coo, W32, alpha, m, by_cols=True)
        cv = coo.with_values(coo.values * (1.0 + alpha * coo.values))
        rhs = wt_v(cv, W).T.astype(jnp.float32)            # (m, r)
        Hn = solve(G[None] + dG, rhs, lambda_h, eps, H.T)
        return Hn.T.astype(H.dtype)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def als_update_masked_sparse(coo, W, H, lambda_w=0.0, lambda_h=0.0,
                             eps=1e-9, order="WH", solver="exact",
                             cg_steps=3):
    """Exact matrix-completion ALS: minimizes Σ_obs (v − wh)² + λ‖·‖²
    by solving, per row u, the OBSERVED-only normal equations

        (Σ_{i∈obs(u)} h_i h_iᵀ + (λ+eps)I) w_u = Σ_{i∈obs(u)} v_ui h_i

    — the iALS solver with a 0/1 confidence (weight 1 on the stored
    set, 0 elsewhere; no shared base Gram, because unobserved entries
    carry NO weight, unlike iALS where they weigh 1). Same machinery
    (`_weighted_row_grams` with the indicator weight, batched
    Cholesky), same O(nnz·r²) + O((n+m)·r³) cost and (n+m)·r²·4-byte
    Gram memory (driver-validated). Rows with no observations solve to
    0 under the (λ+eps) ridge. Nonnegativity via clamping (the
    reference ALS family's clamp semantics)."""
    n, m = coo.shape
    W = jnp.asarray(W)
    H = jnp.asarray(H)
    indicator = lambda v: (v != 0)  # noqa: E731
    solve = _row_solver(solver, cg_steps)

    def upd_w(W, H):
        Ht32 = H.T.astype(jnp.float32)
        dG = _weighted_row_grams(coo, Ht32, 0.0, n, weight_fn=indicator)
        rhs = v_ht(coo, H).astype(jnp.float32)             # (n, r)
        Wn = solve(dG, rhs, lambda_w, eps, W)
        return Wn.astype(W.dtype)

    def upd_h(W, H):
        W32 = W.astype(jnp.float32)
        dG = _weighted_row_grams(coo, W32, 0.0, m, by_cols=True,
                                 weight_fn=indicator)
        rhs = wt_v(coo, W).T.astype(jnp.float32)           # (m, r)
        Hn = solve(dG, rhs, lambda_h, eps, H.T)
        return Hn.T.astype(H.dtype)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def hals_update_sparse(coo, W, H, eps=1e-9, order="WH", l2_w=0.0,
                       l2_h=0.0, l1_w=0.0, l1_h=0.0):
    """HALS on sparse V: the numerators are the usual SpMMs (V stays
    sparse), the cyclic column sweeps are shared with the dense path
    (linalg.dense._hals_half_sweep — V is never touched inside)."""
    r = W.shape[1]
    eye = jnp.eye(r, dtype=W.dtype)

    def sweep_w(W, H):
        return D.hals_half_sweep(
            v_ht(coo, H) - l1_w, D.gram_rows(H) + l2_w * eye, W
        )

    def sweep_h(W, H):
        return D.hals_half_sweep(
            wt_v(coo, W).T - l1_h, D.gram_cols(W) + l2_h * eye, H.T
        ).T

    if order == "WH":
        W = sweep_w(W, H)
        H = sweep_h(W, H)
    else:
        H = sweep_h(W, H)
        W = sweep_w(W, H)
    return W, H


def gdcls_update_sparse(coo, W, H, lambda_tik=0.0, eps=1e-9, order="WH"):
    """GDCLS sparse: MU step for W, Tikhonov LS for H."""

    def upd_w(W, H):
        return W * (v_ht(coo, H) / (W @ D.gram_rows(H) + eps))

    def upd_h(W, H):
        return _solve_clamped(D.gram_cols(W), wt_v(coo, W), lambda_tik, 0.0,
                              eps)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def nsnmf_update_sparse(coo, W, H, S, eps=1e-9, objective="frobenius",
                        order="WH"):
    """Sparse nsNMF: MU against the smoothed partners (SH for W, WS for H)."""
    if objective == "frobenius":

        def upd_w(W, H):
            SH = S @ H
            return W * (v_ht(coo, SH) / (W @ D.gram_rows(SH) + eps))

        def upd_h(W, H):
            WS = W @ S
            return H * (wt_v(coo, WS) / (D.gram_cols(WS) @ H + eps))

    else:  # KL

        def upd_w(W, H):
            SH = S @ H
            ratio = coo.with_values(coo.values / (sddmm(coo, W, SH) + eps))
            denom = jnp.maximum(jnp.sum(SH, axis=1), eps)[None, :]
            return W * (v_ht(ratio, SH) / denom)

        def upd_h(W, H):
            WS = W @ S
            ratio = coo.with_values(coo.values / (sddmm(coo, WS, H) + eps))
            denom = jnp.maximum(jnp.sum(WS, axis=0), eps)[:, None]
            return H * (wt_v(ratio, WS) / denom)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


# ---------------------------------------------------------------------------
# Sparse algorithm registry (mirrors nmftpu.algorithms.registry)
# ---------------------------------------------------------------------------


def build_sparse_update(config: NmfConfig):
    """Returns (make_aux, update, effective_h) for the sparse path."""
    eps = config.eps
    order = config.update_order
    alg = config.algorithm
    obj = config.objective

    def ident_h(aux, H):
        return H

    if alg is Algorithm.MU:
        if config.mask == "observed":
            upd = (mu_update_frobenius_masked
                   if obj is Objective.FROBENIUS else mu_update_kl_masked)
            return (
                lambda coo: (),
                lambda coo, aux, W, H: upd(coo, W, H, eps=eps,
                                           order=order),
                ident_h,
            )
        if obj is Objective.FROBENIUS and config.alpha_confidence > 0.0:
            alpha = config.alpha_confidence
            return (
                lambda coo: (),
                lambda coo, aux, W, H: mu_update_frobenius_weighted_sparse(
                    coo, W, H, alpha, eps=eps, order=order
                ),
                ident_h,
            )
        if obj is Objective.FROBENIUS:
            return (
                lambda coo: (),
                lambda coo, aux, W, H: mu_update_frobenius_sparse(
                    coo, W, H, eps=eps, order=order
                ),
                ident_h,
            )
        if obj is Objective.BETA:
            b_ = config.beta
            return (
                lambda coo: (),
                lambda coo, aux, W, H: mu_update_beta_sparse(
                    coo, W, H, b_, eps=eps, order=order
                ),
                ident_h,
            )
        assert obj is Objective.KL, obj
        return (
            lambda coo: (),
            lambda coo, aux, W, H: mu_update_kl_sparse(
                coo, W, H, eps=eps, order=order
            ),
            ident_h,
        )

    if alg is Algorithm.ALS and config.mask == "observed":
        lw, lh = config.lambda_w, config.lambda_h
        sv, cgs = config.als_solver, config.cg_steps
        return (
            lambda coo: (),
            lambda coo, aux, W, H: als_update_masked_sparse(
                coo, W, H, lambda_w=lw, lambda_h=lh, eps=eps,
                order=order, solver=sv, cg_steps=cgs,
            ),
            ident_h,
        )

    if alg is Algorithm.ALS and config.alpha_confidence > 0.0:
        a = config.alpha_confidence
        lw, lh = config.lambda_w, config.lambda_h
        sv, cgs = config.als_solver, config.cg_steps
        return (
            lambda coo: (),
            lambda coo, aux, W, H: als_update_weighted_sparse(
                coo, W, H, a, lambda_w=lw, lambda_h=lh, eps=eps,
                order=order, solver=sv, cg_steps=cgs,
            ),
            ident_h,
        )

    if alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        sw, sh, ow, oh = _als_family_shifts(config)
        return (
            lambda coo: (),
            lambda coo, aux, W, H: als_family_update_sparse(
                coo, W, H, shift_w=sw, shift_h=sh, off_w=ow, off_h=oh,
                eps=eps, order=order,
            ),
            ident_h,
        )

    if alg is Algorithm.HALS:
        lw, lh = config.lambda_w, config.lambda_h
        l1w, l1h = config.l1_w, config.l1_h
        return (
            lambda coo: (),
            lambda coo, aux, W, H: hals_update_sparse(
                coo, W, H, eps=eps, order=order, l2_w=lw, l2_h=lh,
                l1_w=l1w, l1_h=l1h,
            ),
            ident_h,
        )

    if alg is Algorithm.GDCLS:
        lt = config.lambda_tik
        return (
            lambda coo: (),
            lambda coo, aux, W, H: gdcls_update_sparse(
                coo, W, H, lambda_tik=lt, eps=eps, order=order
            ),
            ident_h,
        )

    if alg is Algorithm.NSNMF:
        theta = config.theta
        rank = config.rank
        obj_name = "frobenius" if obj is Objective.FROBENIUS else "kl"
        return (
            lambda coo: (
                D.nsnmf_smoothing_matrix(rank, theta, dtype=coo.values.dtype),
            ),
            lambda coo, aux, W, H: nsnmf_update_sparse(
                coo, W, H, aux[0], eps=eps, objective=obj_name, order=order
            ),
            lambda aux, H: aux[0] @ H,
        )

    raise ValueError(f"unknown algorithm: {alg}")


# ---------------------------------------------------------------------------
# Sparse initialization (SURVEY.md C8, without densifying V)
# ---------------------------------------------------------------------------


def extract_columns(coo: DeviceCOO, col_idx) -> jax.Array:
    """Densify k selected columns of V -> (n, k) via a masked scatter."""
    col_idx = jnp.asarray(col_idx)
    n = coo.shape[0]
    k = col_idx.shape[0]

    def body(acc, x):
        v, rr, cc = x
        mask = (cc[:, None] == col_idx[None, :]).astype(v.dtype)
        return acc.at[rr].add(v[:, None] * mask), None

    acc0 = jnp.zeros((n, k), coo.values.dtype)
    acc, _ = lax.scan(body, acc0, _chunked(coo))
    return acc


def kmeans_columns_sparse(coo: DeviceCOO, rank, key, max_iter=25):
    """Lloyd's over the columns of sparse V, built from the same SpMM
    primitives (assignment cross-term = (W^T V)^T with W := centroids;
    centroid update = V @ onehot)."""
    m = coo.shape[1]
    dtype = coo.values.dtype
    cols = jax.random.choice(key, m, shape=(rank,), replace=False)
    centroids = extract_columns(coo, cols)                 # (n, r)

    # per-column squared norms of V
    col_sq = col_sums(coo.with_values(coo.values * coo.values))

    def assign(centroids):
        cross = wt_v(coo, centroids).T                     # (m, r)
        cent_sq = jnp.sum(centroids * centroids, axis=0)
        d2 = col_sq[:, None] - 2.0 * cross + cent_sq[None, :]
        return jnp.argmin(d2, axis=1)

    def body(_, centroids):
        labels = assign(centroids)
        onehot = jax.nn.one_hot(labels, rank, dtype=dtype)  # (m, r)
        sums = project_columns(coo, onehot)                 # (n, r)
        counts = jnp.sum(onehot, axis=0)
        new = sums / jnp.maximum(counts, 1.0)[None, :]
        return jnp.where(counts[None, :] > 0, new, centroids)

    centroids = lax.fori_loop(0, max_iter, body, centroids)
    return centroids, assign(centroids)


def col_sums(coo: DeviceCOO) -> jax.Array:
    """Per-column sums of V -> (m,)."""
    m = coo.shape[1]

    acc_dt = _scatter_acc_dtype(coo.values.dtype)

    def body(acc, x):
        v, _, cc = x
        return acc.at[cc].add(v.astype(acc_dt)), None

    acc, _ = lax.scan(body, jnp.zeros((m,), acc_dt), _chunked(coo))
    return acc


def sparse_initialize_factors(
    coo: DeviceCOO, rank, method: Initialization, key,
    W0=None, H0=None, kmeans_max_iter=25,
):
    """The six init strategies against sparse V — no densification."""
    n, m = coo.shape
    dtype = coo.values.dtype
    mean_v = jnp.sum(coo.values) / (float(n) * float(m))
    scale = jnp.sqrt(jnp.maximum(mean_v, 1e-12) / rank).astype(dtype)
    kw, kh, kk = jax.random.split(key, 3)

    def rand(k, shape):
        u = jax.random.uniform(k, shape, dtype=dtype)
        return (u + jnp.asarray(1e-4, dtype)) * scale

    if method is Initialization.COPY_EXISTING:
        if W0 is None or H0 is None:
            raise ValueError("COPY_EXISTING requires both W0 and H0")
        return (
            jnp.array(W0, dtype=dtype, copy=True),
            jnp.array(H0, dtype=dtype, copy=True),
        )

    if method is Initialization.ALL_RANDOM_VALUES:
        return rand(kw, (n, rank)), rand(kh, (rank, m))

    if method is Initialization.MEAN_COLUMNS:
        q = int(min(max(5, m // max(rank, 1)), m))
        cols = jax.random.randint(kk, (rank, q), 0, m)
        # A[j, k] = (#times column j sampled for centroid k) / q
        A = jnp.zeros((m, rank), dtype).at[
            cols.reshape(-1),
            jnp.repeat(jnp.arange(rank), q),
        ].add(1.0 / q)
        W = project_columns(coo, A)
        return W, rand(kh, (rank, m))

    if method in (
        Initialization.NNDSVD,
        Initialization.NNDSVDA,
        Initialization.NNDSVDAR,
    ):
        from nmftpu.init.nndsvd import nndsvd_init

        # host-side one-time truncated SVD (scipy svds — V stays sparse)
        try:
            import scipy.sparse as sps

            k = coo.nnz  # strip the chunk padding
            host = sps.coo_matrix(
                (np.asarray(coo.values)[:k],
                 (np.asarray(coo.rows)[:k], np.asarray(coo.cols)[:k])),
                shape=(n, m),
            ).tocsr()
        except ImportError:
            k = coo.nnz
            host = np.zeros((n, m), np.float64)
            host[np.asarray(coo.rows)[:k], np.asarray(coo.cols)[:k]] = (
                np.asarray(coo.values)[:k]
            )
        seed = int(jax.random.randint(kk, (), 0, 2**31 - 1))
        W, H = nndsvd_init(host, rank, variant=method.value, seed=seed)
        return jnp.asarray(W, dtype), jnp.asarray(H, dtype)

    if method in (
        Initialization.K_MEANS_AND_RANDOM_VALUES,
        Initialization.K_MEANS_AND_NON_NEGATIVE_WTV,
        Initialization.K_MEANS_AND_ABSOLUTE_WTV,
    ):
        centroids, _ = kmeans_columns_sparse(
            coo, rank, kk, max_iter=kmeans_max_iter
        )
        W = jnp.maximum(centroids, 0.0) + jnp.asarray(1e-6, dtype)
        if method is Initialization.K_MEANS_AND_RANDOM_VALUES:
            H = rand(kh, (rank, m))
        elif method is Initialization.K_MEANS_AND_NON_NEGATIVE_WTV:
            H = jnp.maximum(wt_v(coo, W), 0.0) + jnp.asarray(1e-6, dtype)
        else:
            H = jnp.abs(wt_v(coo, W)) + jnp.asarray(1e-6, dtype)
        return W, H

    raise ValueError(f"unknown initialization method: {method}")


# ---------------------------------------------------------------------------
# Sparse driver
# ---------------------------------------------------------------------------

_RUNNER_CACHE: dict[tuple, Callable] = {}


def _sparse_ops_bundle(config: NmfConfig) -> LoopOps:
    make_aux, update, effective_h = build_sparse_update(config)
    if config.mask == "observed":
        # completion semantics: every reported metric (incl. the RMSD
        # denominator) is over the OBSERVED set, not nm
        return LoopOps(
            make_aux=make_aux,
            update=update,
            effective_h=effective_h,
            frobenius=lambda coo, aux, W, He, svsq: (
                frobenius_error_masked(coo, W, He)
            ),
            kl=lambda coo, aux, W, He: kl_error_masked(coo, W, He),
            sum_v_sq=lambda coo: jnp.asarray(0.0, jnp.float32),
            numel=lambda coo, _nnz=None: coo.nnz,
        )
    if config.objective is Objective.BETA:
        b_ = config.beta
        divergence = lambda coo, aux, W, He: beta_divergence_sparse(  # noqa: E731
            coo, W, He, b_
        )
    else:
        divergence = lambda coo, aux, W, He: kl_error(coo, W, He)  # noqa: E731
    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda coo, aux, W, He, svsq: frobenius_error(
            coo, W, He, svsq
        ),
        kl=divergence,
        sum_v_sq=lambda coo: jnp.sum(
            jnp.square(coo.values.astype(
                _scatter_acc_dtype(coo.values.dtype)
            ))
        ),
        numel=lambda coo: coo.shape[0] * coo.shape[1],
    )


def densify_budget_bytes() -> int:
    """Device-memory budget of the densified strategy (see
    nmftpu.densified): matrices up to this dense footprint run as dense
    GEMMs instead of the gather/scatter path. Override with
    NMFTPU_DENSIFY_BUDGET_BYTES."""
    return backend.memory_budget("NMFTPU_DENSIFY_BUDGET_BYTES")


def _densified_supported(config: NmfConfig) -> bool:
    return True  # every algorithm/objective combination


def _als_family_shifts(config: NmfConfig):
    """(shift_w, shift_h, off_w, off_h) for the generic ALS-family solve:
    ALS = plain normal equations, ACLS = diagonal sparsity penalties,
    AHCLS = Hoyer-target diagonal + off-diagonal shifts (Langville et al.)."""
    if config.algorithm is Algorithm.ALS:
        return 0.0, 0.0, 0.0, 0.0
    if config.algorithm is Algorithm.ACLS:
        return config.lambda_w, config.lambda_h, 0.0, 0.0
    r = config.rank

    def hoyer(lam, a):
        sr = float(np.sqrt(r))
        beta = ((1.0 - a) * sr + a) ** 2 / r
        return lam * beta, lam * (1.0 - beta)

    sw, ow = hoyer(config.lambda_w, config.alpha_w)
    sh, oh = hoyer(config.lambda_h, config.alpha_h)
    return sw, sh, ow, oh


def _densified_ops_bundle(config: NmfConfig, coo: DeviceCOO) -> LoopOps:
    from nmftpu import densified as DF

    eps = config.eps
    order = config.update_order
    alg = config.algorithm

    def ident_h(aux, H):
        return H

    effective_h = ident_h
    make_aux = lambda Vd: ()  # noqa: E731

    if config.v_storage == "int8":
        # Operand is the (Vq int8, scale) pair from densify_quantized;
        # config validation guarantees Frobenius + unweighted here. The
        # O(nmr) contractions run int8 x int8 -> int32 for every
        # algorithm; r x r solves stay exact f32.
        if alg is Algorithm.MU:
            if config.objective is Objective.KL:
                def update_q(V, aux, W, H):
                    return DF.mu_update_kl_densified(
                        V[0], W, H, eps=eps, order=order, scale=V[1]
                    )
            elif config.objective is Objective.BETA:
                _beta = config.beta

                def update_q(V, aux, W, H):
                    return DF.mu_update_beta_densified(
                        V[0], W, H, _beta, eps=eps, order=order,
                        scale=V[1],
                    )
            elif config.alpha_confidence > 0.0:
                a = config.alpha_confidence

                def update_q(V, aux, W, H):
                    return DF.mu_update_frobenius_weighted_densified(
                        V[0], W, H, a, eps=eps, order=order, scale=V[1]
                    )
            else:
                def update_q(V, aux, W, H):
                    return D.mu_update_frobenius_int8x8(
                        V[0], V[1], W, H, eps=eps, order=order
                    )
        elif alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
            sw, sh, ow, oh = _als_family_shifts(config)

            def update_q(V, aux, W, H):
                return D.als_family_update_int8x8(
                    V[0], V[1], W, H, shift_w=sw, shift_h=sh,
                    off_w=ow, off_h=oh, eps=eps, order=order,
                )
        elif alg is Algorithm.GDCLS:
            lt = config.lambda_tik

            def update_q(V, aux, W, H):
                return D.gdcls_update_int8x8(
                    V[0], V[1], W, H, lambda_tik=lt, eps=eps, order=order
                )
        else:  # NSNMF
            theta = config.theta
            rank = config.rank

            def make_aux(V):
                return (
                    D.nsnmf_smoothing_matrix(rank, theta,
                                             dtype=jnp.float32),
                )

            if config.objective is Objective.KL:
                def update_q(V, aux, W, H):
                    return DF.nsnmf_update_kl_densified(
                        V[0], W, H, aux[0], eps=eps, order=order,
                        scale=V[1],
                    )
            else:
                def update_q(V, aux, W, H):
                    return D.nsnmf_update_frobenius_int8x8(
                        V[0], V[1], W, H, aux[0], eps=eps, order=order
                    )

            def effective_h(aux, H):
                return aux[0] @ H

        if config.objective is Objective.BETA:
            _bq = config.beta
            div_q = lambda V, aux, W, He: DF.beta_divergence_densified(
                V[0], W, He, _bq, scale=V[1]
            )
        else:
            div_q = lambda V, aux, W, He: DF.kl_error_densified(
                V[0], W, He, scale=V[1]
            )
        return LoopOps(
            make_aux=make_aux,
            update=update_q,
            effective_h=effective_h,
            frobenius=lambda V, aux, W, He, svsq: (
                DF.frobenius_error_int8_densified(V[0], V[1], W, He, svsq)
            ),
            kl=div_q,
            sum_v_sq=lambda V: DF.sum_v_sq_int8_densified(V[0], V[1]),
            numel=lambda V, _nm=coo.shape: _nm[0] * _nm[1],
        )

    if alg is Algorithm.MU:
        if (
            config.objective is Objective.FROBENIUS
            and config.alpha_confidence > 0.0
        ):
            a = config.alpha_confidence

            def update(Vd, aux, W, H):
                return DF.mu_update_frobenius_weighted_densified(
                    Vd, W, H, alpha=a, eps=eps, order=order
                )
        elif config.objective is Objective.FROBENIUS:
            def update(Vd, aux, W, H):
                return D.mu_update_frobenius_bf16v(
                    Vd, W, H, eps=eps, order=order
                )
        elif config.objective is Objective.BETA:
            _beta = config.beta

            def update(Vd, aux, W, H):
                return DF.mu_update_beta_densified(
                    Vd, W, H, _beta, eps=eps, order=order
                )
        else:
            def update(Vd, aux, W, H):
                return DF.mu_update_kl_densified(Vd, W, H, eps=eps,
                                                 order=order)
    elif alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        sw, sh, ow, oh = _als_family_shifts(config)

        def update(Vd, aux, W, H):
            return DF.als_family_update_densified(
                Vd, W, H, shift_w=sw, shift_h=sh, off_w=ow, off_h=oh,
                eps=eps, order=order,
            )
    elif alg is Algorithm.GDCLS:
        lt = config.lambda_tik

        def update(Vd, aux, W, H):
            return DF.gdcls_update_densified(
                Vd, W, H, lambda_tik=lt, eps=eps, order=order
            )
    else:  # NSNMF
        theta = config.theta
        rank = config.rank
        kl = config.objective is Objective.KL

        def make_aux(Vd):
            return (
                D.nsnmf_smoothing_matrix(rank, theta, dtype=jnp.float32),
            )

        def update(Vd, aux, W, H):
            if kl:
                return DF.nsnmf_update_kl_densified(
                    Vd, W, H, aux[0], eps=eps, order=order
                )
            return DF.nsnmf_update_densified(
                Vd, W, H, aux[0], eps=eps, order=order
            )

        def effective_h(aux, H):
            return aux[0] @ H

    if config.objective is Objective.BETA:
        _bb = config.beta
        div_b = lambda Vd, aux, W, He: DF.beta_divergence_densified(
            Vd, W, He, _bb
        )
    else:
        div_b = lambda Vd, aux, W, He: DF.kl_error_densified(Vd, W, He)
    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda Vd, aux, W, He, svsq: DF.frobenius_error_densified(
            Vd, W, He, svsq
        ),
        kl=div_b,
        # from the bf16-rounded V, consistent with the bf16 cross term in
        # the Gram-trick error (mixing the exact f32 sum with bf16 products
        # would break the cancellation near convergence); blockwise to
        # avoid a full f32 copy of V
        sum_v_sq=lambda Vd: DF.sum_v_sq_densified(Vd),
        # true (n, m), NOT the padded densified shape: pad rows contribute
        # zero error (W pad rows are zero), so the RMSD denominator must be
        # the real entry count or the in-loop metric understates the RMSD
        # by sqrt(n_pad/n) and stops early.
        numel=lambda Vd, _nm=coo.shape: _nm[0] * _nm[1],
    )


def _ell_ops_bundle(config: NmfConfig) -> LoopOps:
    from nmftpu import sparse_ell as SE

    eps = config.eps
    order = config.update_order
    obj = config.objective
    alg = config.algorithm
    effective_h = lambda aux, H: H  # noqa: E731
    make_aux = lambda pair: ()  # noqa: E731

    if config.mask == "observed":
        # completion on the gather-only layout (MU fro/KL + exact
        # completion ALS). Metrics over the OBSERVED set.
        if alg is Algorithm.ALS:
            lw, lh = config.lambda_w, config.lambda_h
            sv, cgs = config.als_solver, config.cg_steps

            def upd_m(pair, W, H):
                return SE.als_update_masked_ell(
                    pair, W, H, lambda_w=lw, lambda_h=lh, eps=eps,
                    order=order, solver=sv, cg_steps=cgs,
                )
        elif obj is Objective.FROBENIUS:
            def upd_m(pair, W, H):
                return SE.mu_update_frobenius_masked_ell(
                    pair, W, H, eps=eps, order=order)
        else:
            def upd_m(pair, W, H):
                return SE.mu_update_kl_masked_ell(
                    pair, W, H, eps=eps, order=order)
        return LoopOps(
            make_aux=make_aux,
            update=lambda pair, aux, W, H: upd_m(pair, W, H),
            effective_h=effective_h,
            frobenius=lambda pair, aux, W, He, svsq: (
                SE.frobenius_error_masked_ell(pair, W, He)
            ),
            kl=lambda pair, aux, W, He: SE.kl_error_masked_ell(
                pair, W, He
            ),
            sum_v_sq=lambda pair: jnp.asarray(0.0, jnp.float32),
            numel=lambda pair: pair.rows.nnz,
        )

    if alg is Algorithm.ALS and config.alpha_confidence > 0.0:
        a = config.alpha_confidence
        lw, lh = config.lambda_w, config.lambda_h
        sv, cgs = config.als_solver, config.cg_steps

        def update(pair, aux, W, H):
            return SE.als_update_weighted_ell_exact(
                pair, W, H, a, lambda_w=lw, lambda_h=lh, eps=eps,
                order=order, solver=sv, cg_steps=cgs,
            )
    elif alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        sw, sh, ow, oh = _als_family_shifts(config)

        def update(pair, aux, W, H):
            return SE.als_family_update_ell(
                pair, W, H, shift_w=sw, shift_h=sh, off_w=ow, off_h=oh,
                eps=eps, order=order,
            )
    elif alg is Algorithm.GDCLS:
        lt = config.lambda_tik

        def update(pair, aux, W, H):
            return SE.gdcls_update_ell(pair, W, H, lambda_tik=lt, eps=eps,
                                       order=order)
    elif alg is Algorithm.NSNMF:
        theta = config.theta
        rank = config.rank
        kl_obj = obj is Objective.KL

        def make_aux(pair):
            return (
                D.nsnmf_smoothing_matrix(rank, theta, dtype=jnp.float32),
            )

        def update(pair, aux, W, H):
            if kl_obj:
                return SE.nsnmf_update_kl_ell(pair, W, H, aux[0], eps=eps,
                                              order=order)
            return SE.nsnmf_update_ell(pair, W, H, aux[0], eps=eps,
                                       order=order)

        def effective_h(aux, H):
            return aux[0] @ H
    elif obj is Objective.FROBENIUS and config.alpha_confidence > 0.0:
        a = config.alpha_confidence

        def update(pair, aux, W, H):
            return SE.mu_update_frobenius_weighted_ell(
                pair, W, H, a, eps=eps, order=order
            )
    elif obj is Objective.FROBENIUS:

        def update(pair, aux, W, H):
            return SE.mu_update_frobenius_ell(pair, W, H, eps=eps,
                                              order=order)
    elif obj is Objective.BETA:
        b_ = config.beta

        def update(pair, aux, W, H):
            return SE.mu_update_beta_ell(pair, W, H, b_, eps=eps,
                                         order=order)
    else:

        def update(pair, aux, W, H):
            return SE.mu_update_kl_ell(pair, W, H, eps=eps, order=order)

    if obj is Objective.BETA:
        bd_ = config.beta
        divergence = lambda pair, aux, W, He: SE.beta_divergence_ell(  # noqa: E731
            pair, W, He, bd_
        )
    else:
        divergence = lambda pair, aux, W, He: SE.kl_error_ell(pair, W, He)  # noqa: E731
    return LoopOps(
        make_aux=make_aux,
        update=update,
        effective_h=effective_h,
        frobenius=lambda pair, aux, W, He, svsq: SE.frobenius_error_ell(
            pair, W, He, svsq
        ),
        kl=divergence,
        sum_v_sq=lambda pair: SE.sum_v_sq_ell(pair.rows),
        numel=lambda pair: pair.shape[0] * pair.shape[1],
    )


def _check_weighted_gram_budget(n: int, m: int, rank: int) -> None:
    """iALS materializes (n, r, r) + (m, r, r) f32 Gram deltas; refuse
    clearly instead of an opaque device OOM."""
    budget = backend.memory_budget("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES")
    need = (n + m) * rank * rank * 4
    if need > budget:
        raise ValueError(
            f"weighted ALS per-row Grams need ~{need / 2**30:.1f} "
            f"GiB ((n+m)\u00b7r\u00b2 f32) \u2014 over the "
            f"{budget / 2**30:.1f} GiB budget "
            "(NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES). Lower the rank "
            "or use the weighted MU algorithm."
        )


def _resolve_strategy(V, config: NmfConfig, strategy: str, n: int,
                      m: int) -> str:
    if config.mask == "observed":
        if strategy == "densified":
            raise ValueError(
                "mask='observed' cannot run the densified engine: "
                "densifying materializes the unobserved entries as "
                "zero-valued DATA, which is exactly what the completion "
                "objective must not do; use 'ell' (MU) or 'scatter'"
            )
        if strategy == "auto":
            if config.dtype == "float64":
                # ELL accumulates f32; scatter honors the x64 contract
                strategy = "scatter"
            else:
                # gather-only masked paths: one fused gather per
                # half-step serves numerator + SDDMM/Gram + denominator
                strategy = "ell"
    if strategy == "auto":
        if config.objective is Objective.BETA:
            # every engine runs a float beta_loss now (r3 verdict item
            # 7): densified when V fits the densify budget (dense GEMM
            # panels), ELL beyond it (gather numerators + streamed
            # denominators), scatter for the f64 exactness contract
            if config.dtype == "float64":
                return "scatter"
            v_bytes_b = 1 if config.v_storage == "int8" else 2
            if v_bytes_b * n * m <= densify_budget_bytes():
                return "densified"
            return "ell"
        if (config.algorithm is Algorithm.ALS
                and config.alpha_confidence > 0.0):
            # iALS is sparse-aware by construction (O(nnz·r²) Gram
            # deltas); the ELL engine builds them as batched GEMMs
            # with segment-level scatter; scatter remains the f64-exact
            # oracle
            return "scatter" if config.dtype == "float64" else "ell"
        if config.algorithm is Algorithm.HALS:
            # the cyclic column sweeps read exact numerators: the
            # scatter engine keeps V at full precision
            return "scatter"
        if config.dtype == "float64":
            # scatter is the only engine that holds values AND
            # accumulates at f64; densified stores bf16 and ELL
            # accumulates f32 — silent downgrades the x64 contract
            # (config.resolve_dtype) exists to prevent
            return "scatter"
        v_bytes = 1 if config.v_storage == "int8" else 2
        if (
            _densified_supported(config)
            and v_bytes * n * m <= densify_budget_bytes()
        ):
            return "densified"
        if not isinstance(V, DeviceCOO):
            # beyond the densify budget: gather-only ELL beats the
            # scatter path ~3x (PERF.md)
            return "ell"
        return "scatter"
    return strategy


class SparsePlan:
    """Device-resident sparse operand reusable across runs.

    `prepare_sparse` pays the one-time layout cost ONCE (ELL bucket
    build, densify scatter — seconds at ML-20M scale); `.run()` executes
    the factorization loop, with compiled runners cached per config. Use
    for hyperparameter sweeps / repeated factorizations of one matrix.
    """

    def __init__(self, *, coo, operand, strategy, dtype, config, n_pad):
        self.coo = coo
        self.operand = operand
        self.strategy = strategy
        self.dtype = dtype
        self.config = config
        self.n_pad = n_pad
        self.shape = coo.shape

    def _bundle(self, config: NmfConfig) -> LoopOps:
        if self.strategy == "ell":
            return _ell_ops_bundle(config)
        if self.strategy == "densified":
            return _densified_ops_bundle(config, self.coo)
        return _sparse_ops_bundle(config)

    def run(
        self,
        config: NmfConfig | None = None,
        W0=None,
        H0=None,
        callback: Callable[[Any, Any, Any, Any], None] | None = None,
        interrupt: Callable[[], bool] | None = None,
    ) -> NmfResult:
        """Execute the factorization loop on the prepared layout."""
        if config is None:
            config = self.config
        n, m = self.shape
        if config.rank > min(n, m):
            raise ValueError(
                f"rank {config.rank} exceeds min(V.shape) = {min(n, m)}"
            )
        if jnp.dtype(config.dtype) != self.dtype:
            raise ValueError(
                f"config.dtype {config.dtype} differs from the plan's "
                f"layout dtype {self.dtype}; re-run prepare_sparse"
            )
        if self.strategy == "densified" and (
            (config.v_storage == "int8")
            != (self.config.v_storage == "int8")
        ):
            raise ValueError(
                "config.v_storage changes the densified layout "
                f"({self.config.v_storage!r} at prepare time vs "
                f"{config.v_storage!r}); re-run prepare_sparse"
            )
        if (config.algorithm is Algorithm.ALS
                and (config.alpha_confidence > 0.0
                     or config.mask == "observed")
                and self.strategy not in ("scatter", "ell")):
            raise ValueError(
                "weighted/masked ALS runs on the 'ell' or 'scatter' "
                f"engines; this plan's strategy is {self.strategy!r} — "
                "re-run prepare_sparse with strategy='ell'/'scatter'"
            )
        if (config.algorithm is Algorithm.ALS
                and (config.alpha_confidence > 0.0
                     or config.mask == "observed")):
            _check_weighted_gram_budget(n, m, config.rank)
        if self.strategy in ("ell", "scatter") \
                and config.v_storage != "float32":
            # same contract as prepare_sparse: these engines would
            # silently ignore the low-precision storage request
            raise ValueError(
                f"v_storage={config.v_storage!r} is only honored by the "
                f"'densified' sparse engine; this plan's strategy is "
                f"{self.strategy!r}"
            )

        cache_key = (config, self.shape, self.strategy, str(self.dtype))
        if callback is not None or interrupt is not None:
            runner = build_runner(config, self._bundle(config), callback,
                                  interrupt)
        else:
            runner = _RUNNER_CACHE.get(cache_key)
            if runner is None:
                runner = build_runner(config, self._bundle(config), None)
                _RUNNER_CACHE[cache_key] = runner

        coo, n_pad = self.coo, self.n_pad

        def init_fn(key):
            W, H = sparse_initialize_factors(
                coo, config.rank, config.init_method, key,
                W0=W0, H0=H0, kmeans_max_iter=config.kmeans_max_iter,
            )
            if n_pad != n:  # zero rows are absorbing under every rule
                W = jnp.pad(W, ((0, n_pad - n), (0, 0)))
            return W, H

        result = execute(
            self.operand, config, runner, init_fn,
            # masked runs report every metric over the OBSERVED set
            numel=(self.coo.nnz if config.mask == "observed"
                   else n * m),
        )
        if n_pad != n:
            result.W = result.W[:n]
        return result


def prepare_sparse(
    V: host_sparse.SparseMatrix | DeviceCOO,
    config: NmfConfig,
    strategy: str = "auto",
) -> SparsePlan:
    """Build the device layout for sparse V once, returning a reusable
    :class:`SparsePlan`. Strategy resolution and layouts match
    :func:`compute_sparse` (which is now a prepare+run one-shot)."""
    if config.mu_style == "jacobi":
        raise ValueError(
            "mu_style='jacobi' is wired through the dense engine only; "
            "sparse engines run gauss-seidel half-steps"
        )
    dtype = resolve_dtype(config.dtype)
    if isinstance(V, DeviceCOO):
        if V.values.dtype != dtype:
            raise ValueError(
                f"DeviceCOO values are {V.values.dtype} but config.dtype "
                f"is {config.dtype}; re-upload with device_put_sparse("
                "..., dtype=...) or match the config"
            )
        coo = V
    else:
        coo = device_put_sparse(V, dtype=dtype)
    n, m = coo.shape
    if config.rank > min(n, m):
        raise ValueError(
            f"rank {config.rank} exceeds min(V.shape) = {min(n, m)}"
        )
    strategy = _resolve_strategy(V, config, strategy, n, m)
    if strategy not in ("ell", "densified", "scatter"):
        raise ValueError(
            f"strategy must be 'auto', 'ell', 'densified' or 'scatter', "
            f"got {strategy!r}"
        )
    if (config.algorithm is Algorithm.ALS
            and (config.alpha_confidence > 0.0
                 or config.mask == "observed")):
        if strategy not in ("scatter", "ell"):
            raise ValueError(
                "weighted ALS (iALS) and masked ALS run on the 'ell' "
                "(batched-GEMM Gram deltas, the fast path) or 'scatter' "
                f"(f64-exact oracle) engines; strategy resolved to "
                f"{strategy!r}"
            )
        _check_weighted_gram_budget(n, m, config.rank)
    if config.algorithm is Algorithm.HALS and strategy != "scatter":
        raise ValueError(
            "HALS runs on the 'scatter' sparse engine (exact "
            f"numerators); strategy resolved to {strategy!r}"
        )
    if strategy in ("ell", "scatter") and config.v_storage != "float32":
        # These engines keep V's values at the compute dtype and would
        # silently ignore the requested low-precision storage.
        raise ValueError(
            f"v_storage={config.v_storage!r} is only honored by the "
            f"'densified' sparse engine (and the dense path); the "
            f"resolved strategy is {strategy!r}, which would run "
            "full-precision. Pass strategy='densified' (raise "
            "NMFTPU_DENSIFY_BUDGET_BYTES if the matrix exceeds the "
            "densify budget) or v_storage='float32'."
        )

    n_pad = n
    if strategy == "ell":
        if isinstance(V, DeviceCOO):
            raise ValueError("ell strategy needs a host sparse container")
        from nmftpu import sparse_ell as SE

        operand = SE.build_ell_pair(V, dtype=dtype)
    elif strategy == "densified":
        from nmftpu import densified as DF

        # rows padded to the blocked-update panel size: downstream pads
        # become no-ops instead of full-matrix copies (OOM at ML-20M
        # scale)
        if config.v_storage == "int8":
            operand = DF.densify_quantized(coo, row_multiple=4096)
            n_pad = operand[0].shape[0]
        else:
            operand = DF.densify(coo, row_multiple=4096)
            n_pad = operand.shape[0]
    else:
        operand = coo

    return SparsePlan(coo=coo, operand=operand, strategy=strategy,
                      dtype=dtype, config=config, n_pad=n_pad)


def compute_sparse(
    V: host_sparse.SparseMatrix | DeviceCOO,
    config: NmfConfig,
    W0=None,
    H0=None,
    strategy: str = "auto",
    callback: Callable[[Any, Any, Any, Any], None] | None = None,
    interrupt: Callable[[], bool] | None = None,
) -> NmfResult:
    """Sparse twin of `nmftpu.driver.compute`: V stays sparse end-to-end.

    strategy:
      "scatter"   — chunked COO gather/scatter updates (any size);
      "densified" — scatter V once into dense bf16 and run dense GEMM
                    updates (all six algorithms, both objectives; chosen
                    when n*m*2 bytes fit densify_budget_bytes()); with
                    v_storage="int8" V densifies to int8 + scale: the
                    Frobenius family contracts int8 x int8 and KL folds
                    the scale into its blockwise numerators, at half the
                    footprint either way;
      "ell"       — gather-only bucketed padded-segment layout (MU family;
                    the beyond-budget alternative to scatter);
      "auto"      — densified when supported and within
                    densify_budget_bytes(), else scatter.

    Repeated factorizations of the same matrix should use
    :func:`prepare_sparse` once and call ``plan.run(...)`` per sweep
    point — this function rebuilds the device layout on every call.
    """
    plan = prepare_sparse(V, config, strategy=strategy)
    return plan.run(W0=W0, H0=H0, callback=callback, interrupt=interrupt)
