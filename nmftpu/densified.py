"""Densified-bf16 sparse strategy.

Gather/scatter SpMM runs far below dense GEMM rates, so whenever the
interaction matrix fits device memory as bfloat16 (ML-20M is 7.4 GB),
the "sparse" engine can be: scatter the nonzeros into a dense bf16 V
ONCE, then run dense GEMM updates — computing the zeros instead of
gathering around them. `sparse_ops.densify_budget_bytes()` decides
how large a matrix may be densified. The Frobenius objective is
unchanged (it is defined over all nm entries); KL runs blockwise over
row panels so the dense ratio matrix V/(WH) never materializes at full
size.

The chunked scan+scatter path (nmftpu.sparse_ops) remains the fallback for
matrices beyond that budget and for the per-device tiles of the sharded
engine.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from nmftpu.linalg import dense as D
from nmftpu.sparse_ops import DeviceCOO, _chunked


def densify(coo: DeviceCOO, dtype=jnp.bfloat16,
            row_multiple: int = 1) -> jax.Array:
    """Scatter the padded COO into a dense (n_pad, m) array of `dtype`,
    once; n_pad rounds n up to `row_multiple` so the blocked update paths
    never need a (copying) jnp.pad of the full matrix. The extra zero rows
    are absorbing under every update rule.

    Padding entries add 0 at (0, 0) — exact no-ops. Duplicates sum.
    """
    n, m = coo.shape
    n_pad = ((n + row_multiple - 1) // row_multiple) * row_multiple

    def body(acc, x):
        v, rr, cc = x
        return acc.at[rr, cc].add(v.astype(dtype)), None

    acc0 = jnp.zeros((n_pad, m), dtype)
    acc, _ = lax.scan(body, acc0, _chunked(coo))
    return acc


def densify_quantized(coo: DeviceCOO, row_multiple: int = 1,
                      clip: float = 127.0):
    """Scatter the padded COO into a dense int8 array with one symmetric
    per-matrix scale: V ~= scale * Vq. Same padding contract as
    `densify`. The int8 matrix is half the bf16 footprint and feeds the
    int8 x int8 contractions (`mu_update_frobenius_int8x8`).

    Per-entry quantization error <= scale/2 (<=0.4% of the matrix max);
    exact when values lie on a <=255-level uniform grid. Duplicate
    coordinates sum in int8 (same caveat as the bf16 path)."""
    n, m = coo.shape
    n_pad = ((n + row_multiple - 1) // row_multiple) * row_multiple
    scale = jnp.maximum(
        jnp.max(jnp.abs(coo.values)) / clip, 1e-30
    ).astype(jnp.float32)

    def body(acc, x):
        v, rr, cc = x
        q = jnp.clip(
            jnp.round(v.astype(jnp.float32) / scale), -clip, clip
        ).astype(jnp.int8)
        return acc.at[rr, cc].add(q), None

    acc0 = jnp.zeros((n_pad, m), jnp.int8)
    acc, _ = lax.scan(body, acc0, _chunked(coo))
    return acc, scale


@functools.partial(jax.jit, static_argnames=("block_rows",))
def frobenius_error_int8_densified(Vq, scale, W, H, sum_v_sq,
                                   block_rows=4096):
    """Gram-trick ||scale*Vq - WH||_F. The cross term runs blockwise in
    bf16 (int8 -> bf16 is exact, so the only rounding is on W — the same
    as the bf16 engine's error path); `sum_v_sq` must come from
    `sum_v_sq_int8_densified` for the cancellation to hold."""
    n, m = Vq.shape
    r = W.shape[1]
    nb, tail = divmod(n, block_rows)

    def panel(start, rows, acc):
        V_blk = lax.dynamic_slice_in_dim(
            Vq, start, rows, 0
        ).astype(jnp.bfloat16)
        W_blk = lax.dynamic_slice_in_dim(
            W, start, rows, 0
        ).astype(jnp.bfloat16)
        return acc + jax.lax.dot_general(
            W_blk, V_blk, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

    WtV = jnp.zeros((r, m), jnp.float32)
    if nb:  # fori_loop(0, 0) still traces its body
        WtV = lax.fori_loop(
            0, nb, lambda i, a: panel(i * block_rows, block_rows, a), WtV,
        )
    if tail:  # remainder panel — still panel-sized, never full-matrix
        WtV = panel(nb * block_rows, tail, WtV)
    cross = scale * jnp.sum(WtV * H)
    quad = jnp.sum(D.gram_cols(W) * D.gram_rows(H))
    return jnp.sqrt(jnp.maximum(sum_v_sq - 2.0 * cross + quad, 0.0))


@functools.partial(jax.jit, static_argnames=("block_rows",))
def sum_v_sq_int8_densified(Vq, scale, block_rows=4096):
    """||scale*Vq||_F^2 blockwise (no full f32 copy of V)."""
    n, m = Vq.shape
    nb, tail = divmod(n, block_rows)

    def panel(start, rows, acc):
        blk = lax.dynamic_slice_in_dim(
            Vq, start, rows, 0
        ).astype(jnp.float32)
        return acc + jnp.sum(blk * blk)

    total = jnp.asarray(0.0, jnp.float32)
    if nb:  # fori_loop(0, 0) still traces its body
        total = lax.fori_loop(
            0, nb, lambda i, a: panel(i * block_rows, block_rows, a), total,
        )
    if tail:
        total = panel(nb * block_rows, tail, total)
    return scale * scale * total


def _kl_numer_w_blocked(Vd, Q, P, eps, block_rows, scale=None):
    """Blockwise numerator (V / (Q P)) @ P^T -> (n, r) for the left-factor
    KL half-step. Q (n, r) is the left operand forming the reconstruction
    (W, or W for nsNMF), P (r, m) the right partner (H, or S@H).

    `scale` (int8 storage): Vd holds unscaled quantized values and the
    true V is scale * Vd. The ratio scale*Vq/(WH+eps) factors the scalar
    out of the contraction, so it folds into the numerator AFTER the
    GEMM — exact, and the int8 reads quarter the V traffic.

    Row panels are read with dynamic_slice inside a fori_loop — NEVER
    reshaped/stacked into scan xs, which would materialize a second
    V-sized buffer (the ML-20M OOM). A remainder panel (n % block_rows,
    e.g. on the dense-registry routes where V is not row-padded) is
    processed by the same panel math — intermediates stay panel-sized."""
    n, m = Vd.shape
    r = Q.shape[1]
    nb, tail = divmod(n, block_rows)
    Pb = P.astype(jnp.bfloat16)

    def panel(start, rows, out):
        V_blk = lax.dynamic_slice_in_dim(Vd, start, rows, 0)
        Q_blk = lax.dynamic_slice_in_dim(Q, start, rows, 0)
        WH = jax.lax.dot_general(
            Q_blk.astype(jnp.bfloat16), Pb,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        ratio = V_blk.astype(jnp.float32) / (WH + eps)
        numer = jax.lax.dot_general(
            ratio.astype(jnp.bfloat16), Pb,
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return lax.dynamic_update_slice_in_dim(out, numer, start, 0)

    out = jnp.zeros((n, r), jnp.float32)
    if nb:  # fori_loop(0, 0) still traces its body
        out = lax.fori_loop(
            0, nb, lambda i, o: panel(i * block_rows, block_rows, o), out,
        )
    if tail:
        out = panel(nb * block_rows, tail, out)
    return out if scale is None else out * scale


def _kl_numer_h_blocked(Vd, Q, H, eps, block_rows, scale=None):
    """Blockwise numerator Q^T (V / (Q H)) -> (r, m) for the right-factor
    KL half-step; Q (n, r) is the effective left factor (W, or W@S).
    Same no-copy panel access and int8 scale-folding contract as
    _kl_numer_w_blocked."""
    n, m = Vd.shape
    r = Q.shape[1]
    nb, tail = divmod(n, block_rows)
    Hb = H.astype(jnp.bfloat16)

    def panel(start, rows, acc):
        V_blk = lax.dynamic_slice_in_dim(Vd, start, rows, 0)
        Q_blk = lax.dynamic_slice_in_dim(Q, start, rows, 0)
        WH = jax.lax.dot_general(
            Q_blk.astype(jnp.bfloat16), Hb,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        ratio = V_blk.astype(jnp.float32) / (WH + eps)
        return acc + jax.lax.dot_general(
            Q_blk.astype(jnp.bfloat16), ratio.astype(jnp.bfloat16),
            (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

    out = jnp.zeros((r, m), jnp.float32)
    if nb:  # fori_loop(0, 0) still traces its body
        out = lax.fori_loop(
            0, nb, lambda i, a: panel(i * block_rows, block_rows, a), out,
        )
    if tail:
        out = panel(nb * block_rows, tail, out)
    return out if scale is None else out * scale


def _beta_terms_w_blocked(Vd, W, H, beta, eps, block_rows, scale=None):
    """Blockwise numerator/denominator for the beta-MU W half-step:
    numer = ((WH)^(b-2) . V) H^T, denom = (WH)^(b-1) H^T, both (n, r),
    one pass over V per call. Same panel/no-copy contract as
    _kl_numer_w_blocked; `scale` (int8 storage, V = scale*Vq) enters the
    numerator linearly so it folds in after the contraction."""
    n, m = Vd.shape
    r = W.shape[1]
    nb, tail = divmod(n, block_rows)
    Hb = H.astype(jnp.bfloat16)

    def panel(start, rows, out):
        numer, denom = out
        V_blk = lax.dynamic_slice_in_dim(Vd, start, rows, 0)
        W_blk = lax.dynamic_slice_in_dim(W, start, rows, 0)
        WH = jax.lax.dot_general(
            W_blk.astype(jnp.bfloat16), Hb,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        pwr_n, pwr_d = D._beta_powers(WH, beta)
        num_blk = jax.lax.dot_general(
            (pwr_n * V_blk.astype(jnp.float32)).astype(jnp.bfloat16),
            Hb, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        den_blk = jax.lax.dot_general(
            pwr_d.astype(jnp.bfloat16), Hb,
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return (
            lax.dynamic_update_slice_in_dim(numer, num_blk, start, 0),
            lax.dynamic_update_slice_in_dim(denom, den_blk, start, 0),
        )

    out = (jnp.zeros((n, r), jnp.float32), jnp.zeros((n, r), jnp.float32))
    if nb:  # fori_loop(0, 0) still traces its body
        out = lax.fori_loop(
            0, nb, lambda i, o: panel(i * block_rows, block_rows, o), out,
        )
    if tail:
        out = panel(nb * block_rows, tail, out)
    numer, denom = out
    return (numer if scale is None else numer * scale), denom


def _beta_terms_h_blocked(Vd, W, H, beta, eps, block_rows, scale=None):
    """Blockwise numer = W^T ((WH)^(b-2) . V), denom = W^T (WH)^(b-1),
    both (r, m), accumulated over row panels."""
    n, m = Vd.shape
    r = W.shape[1]
    nb, tail = divmod(n, block_rows)
    Hb = H.astype(jnp.bfloat16)

    def panel(start, rows, acc):
        numer, denom = acc
        V_blk = lax.dynamic_slice_in_dim(Vd, start, rows, 0)
        W_blk = lax.dynamic_slice_in_dim(W, start, rows, 0)
        Wb = W_blk.astype(jnp.bfloat16)
        WH = jax.lax.dot_general(
            Wb, Hb, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        pwr_n, pwr_d = D._beta_powers(WH, beta)
        numer = numer + jax.lax.dot_general(
            Wb,
            (pwr_n * V_blk.astype(jnp.float32)).astype(jnp.bfloat16),
            (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        denom = denom + jax.lax.dot_general(
            Wb, pwr_d.astype(jnp.bfloat16),
            (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return numer, denom

    acc = (jnp.zeros((r, m), jnp.float32), jnp.zeros((r, m), jnp.float32))
    if nb:  # fori_loop(0, 0) still traces its body
        acc = lax.fori_loop(
            0, nb, lambda i, a: panel(i * block_rows, block_rows, a), acc,
        )
    if tail:
        acc = panel(nb * block_rows, tail, acc)
    numer, denom = acc
    return (numer if scale is None else numer * scale), denom


@functools.partial(
    jax.jit, static_argnames=("beta", "eps", "order", "block_rows")
)
def mu_update_beta_densified(
    Vd, W, H, beta, eps=1e-9, order="WH", block_rows=4096, scale=None
):
    """Generalized beta-divergence MU against a dense low-precision V,
    blockwise over row panels (the dense twin is
    linalg.dense.mu_update_beta; Fevotte & Idier / sklearn float
    beta_loss semantics: the EPSILON power guards via D._beta_powers,
    the gamma exponent, and the beta<1 stabilization; `eps` is accepted
    for signature uniformity but unused). One WH materialization per
    half-step, per panel — never at full size."""
    gamma = D.beta_gamma(beta)

    def finish(X, numer, denom):
        d = numer / jnp.where(denom == 0.0, D.EPSILON, denom)
        if gamma != 1.0:
            d = d ** gamma
        X = X * d
        if beta < 1.0:
            X = jnp.where(X < D._STAB_EPS, 0.0, X)
        return X

    def upd_w(W, H):
        numer, denom = _beta_terms_w_blocked(
            Vd, W, H, beta, eps, block_rows, scale
        )
        return finish(W, numer, denom)

    def upd_h(W, H):
        numer, denom = _beta_terms_h_blocked(
            Vd, W, H, beta, eps, block_rows, scale
        )
        return finish(H, numer, denom)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


@functools.partial(jax.jit, static_argnames=("beta", "eps", "block_rows"))
def beta_divergence_densified(Vd, W, H, beta, eps=1e-12,
                              block_rows=4096, scale=None):
    """D_beta(V || WH) blockwise over row panels (dense twin:
    linalg.dense.beta_divergence — same zero-entry eps conventions)."""
    n, m = Vd.shape
    nb, tail = divmod(n, block_rows)
    Hb = H.astype(jnp.bfloat16)

    def panel(start, rows, acc):
        V_blk = lax.dynamic_slice_in_dim(
            Vd, start, rows, 0
        ).astype(jnp.float32)
        if scale is not None:
            V_blk = V_blk * scale
        W_blk = lax.dynamic_slice_in_dim(W, start, rows, 0)
        WH = jax.lax.dot_general(
            W_blk.astype(jnp.bfloat16), Hb,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        WH = jnp.maximum(WH, eps)
        if beta == 0.0:
            div = jnp.maximum(V_blk, eps) / WH
            return acc + jnp.sum(div - jnp.log(div) - 1.0)
        if beta <= 0.0:
            Vb = jnp.maximum(V_blk, eps) ** beta
        else:
            Vb = jnp.where(V_blk > 0, V_blk, 1.0) ** beta
            Vb = jnp.where(V_blk > 0, Vb, 0.0)
        term = (Vb + (beta - 1.0) * WH ** beta
                - beta * V_blk * WH ** (beta - 1.0))
        return acc + jnp.sum(term)

    total = jnp.asarray(0.0, jnp.float32)
    if nb:  # fori_loop(0, 0) still traces its body
        total = lax.fori_loop(
            0, nb, lambda i, a: panel(i * block_rows, block_rows, a), total,
        )
    if tail:
        total = panel(nb * block_rows, tail, total)
    if beta == 0.0:
        return total
    return total / (beta * (beta - 1.0))


@functools.partial(jax.jit, static_argnames=("eps", "order", "block_rows"))
def mu_update_kl_densified(
    Vd, W, H, eps=1e-9, order="WH", block_rows=4096, scale=None
):
    """KL MU against a dense low-precision V, blockwise over row panels.

    Per half-step one pass over V: for each row panel, WH = W_blk @ H and
    the ratio V/(WH) live only at panel size; numerators accumulate into
    (n, r) / (r, m). FLOPs 2×O(nmr) per half-step — GEMM-bound, versus the
    gather-bound scatter path. With `scale` (int8-stored V = scale * Vd)
    the scalar folds into the numerator after the contraction — this is
    also the dense `v_storage` KL path (registry routes bf16/int8 dense
    KL here: bounded intermediates + bf16 GEMMs instead of the f32
    full-materialization update).
    """

    def upd_w(W, H):
        numer = _kl_numer_w_blocked(Vd, W, H, eps, block_rows, scale)
        h_sum = jnp.maximum(jnp.sum(H, axis=1), eps)[None, :]
        return W * (numer / h_sum)

    def upd_h(W, H):
        numer = _kl_numer_h_blocked(Vd, W, H, eps, block_rows, scale)
        w_sum = jnp.maximum(jnp.sum(W, axis=0), eps)[:, None]
        return H * (numer / w_sum)

    if order == "jacobi":
        # simultaneous half-steps with the KL scale correction
        # (linalg.dense.mu_update_kl documents the derivation); the
        # sum over V folds the int8 scale in exactly
        import jax as _jax

        numer_w = _kl_numer_w_blocked(Vd, W, H, eps, block_rows, scale)
        numer_h = _kl_numer_h_blocked(Vd, W, H, eps, block_rows, scale)
        h_sum = jnp.maximum(jnp.sum(H, axis=1), eps)
        w_sum = jnp.maximum(jnp.sum(W, axis=0), eps)
        sum_v = jnp.sum(Vd, dtype=jnp.float32)
        if scale is not None:
            sum_v = sum_v * scale
        s = sum_v / jnp.maximum(jnp.dot(w_sum, h_sum), eps)
        inv_a = _jax.lax.rsqrt(jnp.maximum(s, eps))
        return (W * (numer_w / h_sum[None, :]) * inv_a,
                H * (numer_h / w_sum[:, None]) * inv_a)

    from nmftpu.linalg.dense import _apply_order

    return _apply_order(upd_w, upd_h, W, H, order)


@functools.partial(jax.jit, static_argnames=("eps", "order", "block_rows"))
def nsnmf_update_kl_densified(
    Vd, W, H, S, eps=1e-9, order="WH", block_rows=4096, scale=None
):
    """nsNMF under KL against dense low-precision V: MU-KL half-steps with
    the smoothed partners (S@H stands in for H, W@S for W). `scale` as in
    mu_update_kl_densified (int8-stored V)."""

    def upd_w(W, H):
        SH = S @ H
        numer = _kl_numer_w_blocked(Vd, W, SH, eps, block_rows, scale)
        s_sum = jnp.maximum(jnp.sum(SH, axis=1), eps)[None, :]
        return W * (numer / s_sum)

    def upd_h(W, H):
        WS = W @ S
        numer = _kl_numer_h_blocked(Vd, WS, H, eps, block_rows, scale)
        s_sum = jnp.maximum(jnp.sum(WS, axis=0), eps)[:, None]
        return H * (numer / s_sum)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def _big_vht(Vd, H):
    """V·Hᵀ (n, r) with bf16 V."""
    return jax.lax.dot_general(
        Vd.astype(jnp.bfloat16), jnp.asarray(H).astype(jnp.bfloat16),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
    )


def _big_wtv(W, Vd):
    """Wᵀ·V (r, m) with bf16 V."""
    return jax.lax.dot_general(
        jnp.asarray(W).astype(jnp.bfloat16), Vd.astype(jnp.bfloat16),
        (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32,
    )


_solve_clamped = D.solve_clamped


def als_family_update_densified(
    Vd, W, H, shift_w=0.0, shift_h=0.0, off_w=0.0, off_h=0.0,
    eps=1e-9, order="WH",
):
    """ALS/ACLS/AHCLS against bf16-dense V: the O(nmr) right-hand sides run
    as bf16 contractions; the r×r solves are exact f32."""

    def upd_w(W, H):
        rhs = _big_vht(Vd, H).T                       # (r, n)
        return _solve_clamped(D.gram_rows(H), rhs, shift_w, off_w, eps).T

    def upd_h(W, H):
        rhs = _big_wtv(W, Vd)                         # (r, m)
        return _solve_clamped(D.gram_cols(W), rhs, shift_h, off_h, eps)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def gdcls_update_densified(Vd, W, H, lambda_tik=0.0, eps=1e-9, order="WH"):
    def upd_w(W, H):
        return W * (_big_vht(Vd, H) / (W @ D.gram_rows(H) + eps))

    def upd_h(W, H):
        return _solve_clamped(D.gram_cols(W), _big_wtv(W, Vd), lambda_tik, 0.0,
                              eps)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def nsnmf_update_densified(Vd, W, H, S, eps=1e-9, order="WH"):
    """nsNMF (Frobenius) against bf16-dense V: MU vs the smoothed partners."""

    def upd_w(W, H):
        SH = S @ H
        return W * (_big_vht(Vd, SH) / (W @ D.gram_rows(SH) + eps))

    def upd_h(W, H):
        WS = W @ S
        return H * (_big_wtv(WS, Vd) / (D.gram_cols(WS) @ H + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


@functools.partial(
    jax.jit, static_argnames=("alpha", "eps", "order", "block_rows")
)
def mu_update_frobenius_weighted_densified(
    Vd, W, H, alpha, eps=1e-9, order="WH", block_rows=4096, scale=None
):
    """Confidence-weighted MU (c = 1 + alpha*v) against bf16-dense V,
    blockwise over row panels so C⊙WH never materializes at full size.
    Panels are read via dynamic_slice (no V-sized scan xs — see
    _kl_numer_w_blocked); a remainder panel runs the same panel math, so
    intermediates stay panel-sized for any n.
    `scale` (int8-stored V = scale * Vd): the confidence
    C = 1 + α·scale·Vq is computed per panel in registers — the
    per-entry weight needs no global fold, so int8 storage composes with
    weighting exactly."""
    n, m = Vd.shape
    r = W.shape[1]
    nb, tail = divmod(n, block_rows)

    def panel_cwh(W, H, start, rows):
        """Shared per-panel terms: C = 1 + alpha*V, C⊙V and C⊙(WH)."""
        V_blk = lax.dynamic_slice_in_dim(Vd, start, rows, 0)
        W_blk = lax.dynamic_slice_in_dim(W, start, rows, 0)
        V32 = V_blk.astype(jnp.float32)
        if scale is not None:
            V32 = V32 * scale
        C = 1.0 + alpha * V32
        WH = jax.lax.dot_general(
            W_blk.astype(jnp.bfloat16), H.astype(jnp.bfloat16),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return W_blk, C * V32, C * WH

    # Each half-step computes ONLY its own numerator/denominator: 3 big
    # contractions (WH, CV·partner, CWH·partner) per half, not the 5 a
    # fused carry of all four accumulators would force through the loop
    # (the unused pair cannot be DCE'd out of a fori_loop carry).
    def w_terms(W, H):
        Hb = H.astype(jnp.bfloat16)

        def panel(start, rows, carry):
            nw_out, dw_out = carry
            _, CV, CWH = panel_cwh(W, H, start, rows)
            nw = jax.lax.dot_general(
                CV.astype(jnp.bfloat16), Hb,
                (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            dw = jax.lax.dot_general(
                CWH.astype(jnp.bfloat16), Hb,
                (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            nw_out = lax.dynamic_update_slice_in_dim(nw_out, nw, start, 0)
            dw_out = lax.dynamic_update_slice_in_dim(dw_out, dw, start, 0)
            return (nw_out, dw_out)

        out = (jnp.zeros((n, r), jnp.float32),
             jnp.zeros((n, r), jnp.float32))
        if nb:  # fori_loop(0, 0) still traces its body
            out = lax.fori_loop(
                0, nb, lambda i, c: panel(i * block_rows, block_rows, c), out,
            )
        if tail:
            out = panel(nb * block_rows, tail, out)
        return out

    def h_terms(W, H):
        def panel(start, rows, carry):
            nh, dh = carry
            W_blk, CV, CWH = panel_cwh(W, H, start, rows)
            Wb = W_blk.astype(jnp.bfloat16)
            nh = nh + jax.lax.dot_general(
                Wb, CV.astype(jnp.bfloat16),
                (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            dh = dh + jax.lax.dot_general(
                Wb, CWH.astype(jnp.bfloat16),
                (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            return (nh, dh)

        out = (jnp.zeros((r, m), jnp.float32),
             jnp.zeros((r, m), jnp.float32))
        if nb:  # fori_loop(0, 0) still traces its body
            out = lax.fori_loop(
                0, nb, lambda i, c: panel(i * block_rows, block_rows, c), out,
            )
        if tail:
            out = panel(nb * block_rows, tail, out)
        return out

    if order == "WH":
        nw, dw = w_terms(W, H)
        W = W * (nw / (dw + eps))
        nh, dh = h_terms(W, H)
        H = H * (nh / (dh + eps))
    else:
        nh, dh = h_terms(W, H)
        H = H * (nh / (dh + eps))
        nw, dw = w_terms(W, H)
        W = W * (nw / (dw + eps))
    return W, H


def frobenius_error_densified(Vd, W, H, sum_v_sq):
    """Gram-trick ||V - WH||_F with bf16 V; `sum_v_sq` must be computed
    from the same bf16-rounded V for consistency with the cross term."""
    WtV = jax.lax.dot_general(
        W.astype(jnp.bfloat16), Vd.astype(jnp.bfloat16),
        (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    cross = jnp.sum(WtV * H)
    quad = jnp.sum(D.gram_cols(W) * D.gram_rows(H))
    return jnp.sqrt(jnp.maximum(sum_v_sq - 2.0 * cross + quad, 0.0))


@functools.partial(jax.jit, static_argnames=("eps", "block_rows"))
def kl_error_densified(Vd, W, H, eps=1e-12, block_rows=4096, scale=None):
    """Blockwise D_KL(V || WH) against dense low-precision V (panel access
    via dynamic_slice — no V-sized intermediates). `scale`: int8-stored
    V = scale * Vd (dequantized per panel in registers)."""
    n, m = Vd.shape
    nb, tail = divmod(n, block_rows)
    Hb = H.astype(jnp.bfloat16)

    def panel(start, rows, acc):
        V_blk = lax.dynamic_slice_in_dim(Vd, start, rows, 0)
        W_blk = lax.dynamic_slice_in_dim(W, start, rows, 0)
        V32 = V_blk.astype(jnp.float32)
        if scale is not None:
            V32 = V32 * scale
        WH = jax.lax.dot_general(
            W_blk.astype(jnp.bfloat16), Hb,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        term = jnp.where(
            V32 > 0,
            V32 * jnp.log(jnp.maximum(V32, eps) / jnp.maximum(WH, eps)),
            0.0,
        )
        return acc + jnp.sum(term - V32 + WH)

    total = jnp.asarray(0.0, jnp.float32)
    if nb:  # fori_loop(0, 0) still traces its body
        total = lax.fori_loop(
            0, nb, lambda i, a: panel(i * block_rows, block_rows, a), total,
        )
    if tail:
        total = panel(nb * block_rows, tail, total)
    return total


@functools.partial(jax.jit, static_argnames=("block_rows",))
def sum_v_sq_densified(Vd, block_rows=4096):
    """||V||_F^2 blockwise in f32 — jnp.sum(square(Vd.astype(f32))) can
    materialize a full f32 copy of V (2x HBM) if the convert fails to fuse
    into the reduction; the panel loop caps the intermediate at panel
    size."""
    n, m = Vd.shape
    nb, tail = divmod(n, block_rows)

    def panel(start, rows, acc):
        blk = lax.dynamic_slice_in_dim(
            Vd, start, rows, 0
        ).astype(jnp.float32)
        return acc + jnp.sum(blk * blk)

    total = jnp.asarray(0.0, jnp.float32)
    if nb:  # fori_loop(0, 0) still traces its body
        total = lax.fori_loop(
            0, nb, lambda i, a: panel(i * block_rows, block_rows, a), total,
        )
    if tail:
        total = panel(nb * block_rows, tail, total)
    return total
