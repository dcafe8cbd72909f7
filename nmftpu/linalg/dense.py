"""Dense update rules and error metrics, pure jnp.

Conventions
-----------
V : (n, m)  nonnegative data ("users" x "items")
W : (n, r)  left factor  (user embeddings)
H : (r, m)  right factor (item embeddings)

All updates return new arrays (functional; no in-place mutation) and are
designed so XLA keeps every matmul a large GEMM: the dominant products are
W^T V (r x m), V H^T (n x r) at O(nmr) FLOPs, plus tiny r x r Grams. The
epsilon guard is *added* to denominators (cheap and branch-free; the
sklearn oracle instead replaces exact zeros — equivalent to tolerance
for positive factors, covered by the parity tests in
tests/test_sklearn_parity.py).

Precision policy (docs/ARCHITECTURE.md): a float32 product may run in
TF32 on the GPU unless a precision is asked for. The O(nmr) numerators
keep the default. The O((n+m) r^2) Gram builds (`gram_rows`,
`gram_cols`), the HALS sweeps and the error checks' contractions ask
for HIGHEST: they feed solves, sequential sweeps and convergence
thresholds, and cost little next to the numerators.

Reference behavior being reproduced: SURVEY.md C3 (MU Frobenius/KL),
C4 (ALS), C5 (ACLS/AHCLS), C6 (GDCLS), C7 (nsNMF), C9 (error metrics),
C13 (the fused elementwise update / clamp kernels), C14 (r x r solves).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


HIGHEST = lax.Precision.HIGHEST


def gram_rows(X):
    """X Xᵀ at full float32 precision (the r x r Gram of an (r, m)
    factor)."""
    return jnp.matmul(X, X.T, precision=HIGHEST)


def gram_cols(X):
    """Xᵀ X at full float32 precision (the r x r Gram of an (n, r)
    factor)."""
    return jnp.matmul(X.T, X, precision=HIGHEST)


# ---------------------------------------------------------------------------
# Multiplicative updates (SURVEY.md C3)
# ---------------------------------------------------------------------------


def mu_update_w_frobenius(V, W, H, eps):
    """W <- W * (V H^T) / (W (H H^T) + eps).   One Lee–Seung half-step."""
    numer = V @ H.T                      # (n, r)   O(nmr)
    HHt = gram_rows(H)                        # (r, r)   O(mr^2)
    denom = W @ HHt + eps                # (n, r)   O(nr^2)
    return W * (numer / denom)


def mu_update_h_frobenius(V, W, H, eps):
    """H <- H * (W^T V) / ((W^T W) H + eps)."""
    numer = W.T @ V                      # (r, m)
    WtW = gram_cols(W)                        # (r, r)
    denom = WtW @ H + eps                # (r, m)
    return H * (numer / denom)


def _apply_order(upd_w, upd_h, W, H, order):
    """Sequence the two MU half-steps: "WH" is Gauss–Seidel with W
    first (the second half-step sees the first's fresh factor — the
    reference's and sklearn's form); "HW" the classic Lee–Seung
    presentation. The "jacobi" coupling does NOT route here — each
    dense update variant implements its scale-corrected simultaneous
    branch explicitly (see _jacobi_fro_apply)."""
    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def _jacobi_fro_apply(W, H, numer_w, numer_h, G_w, G_h, eps):
    """Scale-corrected simultaneous (Jacobi) Frobenius MU step.

    The RAW simultaneous step W ⊙ rw, H ⊙ rh two-cycles on any
    scale-mismatched iterate: each half-step alone fully corrects the
    global scale of WH, so applying both jointly SQUARES the
    correction (measured: a 244↔69 period-2 orbit from the stock
    random init). The fix is closed-form: the optimal global scale
    s = argmin_a ‖V − a·WH‖² = ⟨V, WH⟩/‖WH‖² is already available
    from the update's own pieces — ⟨V, WH⟩ = ⟨numer_w, W⟩ and
    ‖WH‖² = ⟨WᵀW, HHᵀ⟩ — and dividing BOTH ratios by √s yields a step
    invariant to iterate scale (O(nr + r²) extra, nothing reads V
    again). Fixed points are untouched: at any stationary pair
    ⟨V − WH, WH⟩ = 0, so s = 1 and the correction is the identity.
    Measured on the stock init: tracks the Gauss–Seidel error
    trajectory to <2% per iteration (tests/test_jacobi.py)."""
    s_num = jnp.sum(numer_w * W)
    s_den = jnp.maximum(jnp.sum(G_w * G_h), eps)
    inv_a = jax.lax.rsqrt(jnp.maximum(s_num / s_den, eps))
    W_new = W * (numer_w / (W @ G_h + eps)) * inv_a
    H_new = H * (numer_h / (G_w @ H + eps)) * inv_a
    return W_new, H_new


def mu_update_frobenius(V, W, H, eps=1e-9, order="WH"):
    """One full MU iteration under the Frobenius objective.

    order="WH" updates W against the current H first (the sklearn oracle's
    loop order); "HW" is the classic Lee–Seung presentation; "jacobi"
    updates both simultaneously from the incoming factors with the
    closed-form scale correction (see _jacobi_fro_apply) — same fixed
    points, one shared V read for both numerators.
    """
    if order == "jacobi":
        return _jacobi_fro_apply(
            W, H, V @ H.T, W.T @ V, gram_cols(W), gram_rows(H), eps,
        )
    return _apply_order(
        lambda W, H: mu_update_w_frobenius(V, W, H, eps),
        lambda W, H: mu_update_h_frobenius(V, W, H, eps),
        W, H, order,
    )


def mu_update_w_kl(V, W, H, eps):
    """KL half-step: W <- W * ((V / (WH)) H^T) / (row-broadcast sum_j H)."""
    WH = W @ H                           # (n, m)
    ratio = V / (WH + eps)               # (n, m)
    numer = ratio @ H.T                  # (n, r)
    h_sum = jnp.sum(H, axis=1)           # (r,)
    denom = jnp.maximum(h_sum, eps)[None, :]
    return W * (numer / denom)


def mu_update_h_kl(V, W, H, eps):
    """KL half-step: H <- H * (W^T (V / (WH))) / (col-broadcast sum_i W)."""
    WH = W @ H
    ratio = V / (WH + eps)
    numer = W.T @ ratio                  # (r, m)
    w_sum = jnp.sum(W, axis=0)           # (r,)
    denom = jnp.maximum(w_sum, eps)[:, None]
    return H * (numer / denom)


def mu_update_kl(V, W, H, eps=1e-9, order="WH"):
    """One full MU iteration under the KL (generalized I-divergence)
    objective. order="jacobi" computes both half-steps from ONE shared
    WH/ratio pass (Gauss–Seidel needs two) with the KL scale
    correction: argmin_a KL(V ‖ a·WH) has the closed form
    a = ΣV / ΣWH, where ΣWH = ⟨colsum W, rowsum H⟩ — O(nr + mr); both
    ratios divide by √a (the raw simultaneous step squares the scale
    correction exactly as in the Frobenius case). a = 1 at any KL
    stationary point (ΣWH = ΣV there), so fixed points are
    untouched."""
    if order == "jacobi":
        WH = W @ H
        ratio = V / (WH + eps)
        numer_w = ratio @ H.T
        numer_h = W.T @ ratio
        h_sum = jnp.maximum(jnp.sum(H, axis=1), eps)
        w_sum = jnp.maximum(jnp.sum(W, axis=0), eps)
        s = jnp.sum(V) / jnp.maximum(jnp.dot(w_sum, h_sum), eps)
        inv_a = jax.lax.rsqrt(jnp.maximum(s, eps))
        W_new = W * (numer_w / h_sum[None, :]) * inv_a
        H_new = H * (numer_h / w_sum[:, None]) * inv_a
        return W_new, H_new
    return _apply_order(
        lambda W, H: mu_update_w_kl(V, W, H, eps),
        lambda W, H: mu_update_h_kl(V, W, H, eps),
        W, H, order,
    )


def beta_gamma(beta: float) -> float:
    """sklearn's MU exponent for the generalized beta divergence
    (Fevotte & Idier 2011, Thm. 8.8 majorization step): the raw
    multiplicative ratio is raised to gamma to keep the update a
    descent step outside beta in [1, 2]."""
    if beta < 1.0:
        return 1.0 / (2.0 - beta)
    if beta > 2.0:
        return 1.0 / (beta - 1.0)
    return 1.0


# sklearn zeroes factor entries below float64 machine eps after each
# beta<1 half-step ("necessary for stability"); same constant here so
# the parity tests agree on the support pattern.
_STAB_EPS = 2.220446049250313e-16
# sklearn's EPSILON = np.finfo(np.float32).eps: every beta-MU guard
# clamps entries BELOW this up to it (not just exact zeros), regardless
# of the compute dtype. nmftpu.minibatch shares these constants.
EPSILON = 1.1920929e-07


def _beta_powers(WH, beta):
    """sklearn's guarded power pair for one beta-MU half-step:
    (WH^(beta-2) for the numerator, WH^(beta-1) for the denominator).
    Numerator power clamps WH < EPSILON when beta < 2 (negative power
    of ~zero); the denominator clamps only when beta < 1 — two
    SEPARATE guards, exactly as _multiplicative_update_w/_h."""
    WH_n = jnp.maximum(WH, EPSILON) if beta < 2.0 else WH
    if beta == 1.0:
        pwr_n = 1.0 / WH_n
    elif beta == 0.0:
        pwr_n = 1.0 / (WH_n * WH_n)
    else:
        pwr_n = WH_n ** (beta - 2.0)
    WH_d = jnp.maximum(WH, EPSILON) if beta < 1.0 else WH
    pwr_d = WH_d ** (beta - 1.0)
    return pwr_n, pwr_d


def beta_w_step(V, W, H, beta, l1_w=0.0, l2_w=0.0, gamma=1.0):
    """One multiplicative W update under the generalized beta
    divergence — sklearn's _multiplicative_update_w dense branch,
    guard-for-guard (EPSILON clamps, reg on the denominator, the
    final zero-denominator replacement, the gamma exponent)."""
    if beta == 2.0:
        numer = V @ H.T
        denom = W @ gram_rows(H)
    else:
        WH = W @ H
        pwr_n, pwr_d = _beta_powers(WH, beta)
        numer = (pwr_n * V) @ H.T
        if beta == 1.0:
            denom = jnp.broadcast_to(jnp.sum(H, axis=1)[None, :],
                                     W.shape)
        else:
            denom = pwr_d @ H.T
    if l1_w > 0.0:
        denom = denom + l1_w
    if l2_w > 0.0:
        denom = denom + l2_w * W
    denom = jnp.where(denom == 0.0, EPSILON, denom)
    d = numer / denom
    if gamma != 1.0:
        d = d ** gamma
    return W * d


def beta_h_step(V, W, H, beta, l1_h=0.0, l2_h=0.0, gamma=1.0):
    """One multiplicative H update (sklearn _multiplicative_update_h,
    dense branch, without the online A/B accumulators — those live in
    nmftpu.minibatch.h_online_step, built on beta_h_terms)."""
    numer, denom = beta_h_terms(V, W, H, beta)
    if l1_h > 0.0:
        denom = denom + l1_h
    if l2_h > 0.0:
        denom = denom + l2_h * H
    denom = jnp.where(denom == 0.0, EPSILON, denom)
    d = numer / denom
    if gamma != 1.0:
        d = d ** gamma
    return H * d


def beta_h_terms(V, W, H, beta):
    """(numerator, denominator) of the beta-MU H update, pre-
    regularization — shared by the plain step above and the online
    accumulator step in nmftpu.minibatch."""
    if beta == 2.0:
        return W.T @ V, gram_cols(W) @ H
    WH = W @ H
    pwr_n, pwr_d = _beta_powers(WH, beta)
    numer = W.T @ (pwr_n * V)
    if beta == 1.0:
        W_sum = jnp.sum(W, axis=0)
        W_sum = jnp.where(W_sum == 0.0, 1.0, W_sum)
        denom = jnp.broadcast_to(W_sum[:, None], H.shape)
    else:
        denom = W.T @ pwr_d
    return numer, denom


def mu_update_beta(V, W, H, beta, eps=1e-9, order="WH"):
    """One MU iteration under the generalized beta divergence
    (Fevotte & Idier; sklearn's solver='mu' with float beta_loss):

        W <- W * ( ((WH)^(b-2) . V) H^T / ((WH)^(b-1) H^T) )^gamma

    and symmetrically for H. beta=2 is Frobenius and beta=1 is KL (the
    specialized fast paths above); beta=0 is Itakura-Saito. `eps` is
    accepted for registry-signature uniformity but UNUSED — the guards
    are sklearn's fixed EPSILON clamps (see _beta_powers), so float64
    runs match sklearn's _multiplicative_update_w/_h to roundoff even
    on data with zeros / stabilized factor entries. O(nm) full WH per
    half-step — the blockwise twin for low-precision / densified V
    lives in nmftpu.densified.
    """
    gamma = beta_gamma(beta)

    def stabilize(X):
        # sklearn's beta<1 stability: zero sub-machine-eps entries
        if beta < 1.0:
            return jnp.where(X < _STAB_EPS, 0.0, X)
        return X

    def upd_w(W, H):
        return stabilize(beta_w_step(V, W, H, beta, gamma=gamma))

    def upd_h(W, H):
        return stabilize(beta_h_step(V, W, H, beta, gamma=gamma))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def mu_update_frobenius_bf16v(Vb, W, H, eps=1e-9, order="WH"):
    """MU (Frobenius) against a bfloat16-stored V: halves the dominant
    memory traffic; the O(nmr) contractions run bf16 x bf16 -> f32 and
    everything else stays in W/H's dtype."""

    def big_dot(a, b, dims):
        return jax.lax.dot_general(
            a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
            dimension_numbers=(dims, ((), ())),
            preferred_element_type=jnp.float32,
        ).astype(W.dtype)

    def upd_w(W, H):
        numer = big_dot(Vb, H, ((1,), (1,)))       # V H^T (n, r)
        return W * (numer / (W @ gram_rows(H) + eps))

    def upd_h(W, H):
        numer = big_dot(W, Vb, ((0,), (0,)))       # W^T V (r, m)
        return H * (numer / (gram_cols(W) @ H + eps))

    if order == "jacobi":
        return _jacobi_fro_apply(
            W, H, big_dot(Vb, H, ((1,), (1,))),
            big_dot(W, Vb, ((0,), (0,))), gram_cols(W), gram_rows(H), eps,
        )
    return _apply_order(upd_w, upd_h, W, H, order)


def quantize_sym(X, clip=127.0):
    """Symmetric per-matrix int8 quantization: X ~= scale * Xq."""
    scale = jnp.maximum(jnp.max(jnp.abs(X)) / clip, 1e-30)
    Xq = jnp.clip(jnp.round(X / scale), -clip, clip).astype(jnp.int8)
    return scale.astype(jnp.float32), Xq


def quantize_v(V):
    """V -> (Vq int8, scale f32) with V ~= scale * Vq: `quantize_sym` in
    the (data, scale) order the int8-stored-V paths carry. Exact when
    every entry is an integer multiple of max|V|/127; otherwise off by
    at most scale/2 per entry."""
    scale, Vq = quantize_sym(V)
    return Vq, scale


def _rhs_vht_int8(Vq, scale_v, X):
    """V·Xᵀ (n, r) with int8 V: X requantized per call, int8 × int8 →
    int32, both scales in the epilogue."""
    s_x, Xq = quantize_sym(X)
    return jax.lax.dot_general(
        Vq, Xq, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * (scale_v * s_x)


def _rhs_wtv_int8(Vq, scale_v, X):
    """Xᵀ·V (r, m) with int8 V; X requantized per call."""
    s_x, Xq = quantize_sym(X)
    return jax.lax.dot_general(
        Xq, Vq, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * (scale_v * s_x)


def _ls_terms_w_int8(Vq, scale_v, H):
    """(gram, rhs) of the W-side normal equations with H quantized ONCE:
    gram = H̃ H̃ᵀ (r, r) and rhs = H̃ Ṽᵀ (r, n), both from the SAME
    dequantized H̃. Consistency matters: mixing an exact-f32 Gram with a
    quantized rhs perturbs the solve by cond(G) ≈ cond(H)², while the
    consistent pair is the EXACT solution of the quantized LS problem
    (error ∝ cond(H) only). Measured: 22% → <2% H error per ALS step."""
    s_h, Hq = quantize_sym(H)
    Hd = Hq.astype(jnp.float32) * s_h
    gram = gram_rows(Hd)
    rhs = jax.lax.dot_general(
        Hq, Vq, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * (scale_v * s_h)
    return gram, rhs


def _ls_terms_h_int8(Vq, scale_v, W):
    """(gram, rhs) of the H-side normal equations with W quantized once:
    gram = W̃ᵀ W̃ (r, r), rhs = W̃ᵀ Ṽ (r, m). See `_ls_terms_w_int8`."""
    s_w, Wq = quantize_sym(W)
    Wd = Wq.astype(jnp.float32) * s_w
    gram = gram_cols(Wd)
    rhs = jax.lax.dot_general(
        Wq, Vq, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32) * (scale_v * s_w)
    return gram, rhs


def mu_update_frobenius_int8x8(Vq, scale_v, W, H, eps=1e-9, order="WH"):
    """MU (Frobenius) with the O(nmr) contractions as int8 x int8 -> int32:
    V is stored int8 once; the factor operand of each big GEMM is
    re-quantized per half-step and both scales fold into the epilogue.
    Quantization: per-entry relative error <= 0.4% on each operand. The
    dense engine's int8 route dequantizes to bf16 instead, which was
    faster on the H100 (PERF.md); the densified engine calls this."""
    Vq = jnp.asarray(Vq)

    def upd_w(W, H):
        numer = _rhs_vht_int8(Vq, scale_v, H)
        return W * (numer / (W @ gram_rows(H) + eps))

    def upd_h(W, H):
        numer = _rhs_wtv_int8(Vq, scale_v, W)
        return H * (numer / (gram_cols(W) @ H + eps))

    if order == "jacobi":
        return _jacobi_fro_apply(
            W, H, _rhs_vht_int8(Vq, scale_v, H),
            _rhs_wtv_int8(Vq, scale_v, W), gram_cols(W), gram_rows(H),
            eps,
        )
    return _apply_order(upd_w, upd_h, W, H, order)


def als_family_update_int8x8(
    Vq, scale_v, W, H, shift_w=0.0, shift_h=0.0, off_w=0.0, off_h=0.0,
    eps=1e-9, order="WH",
):
    """ALS/ACLS/AHCLS with the O(nmr) right-hand sides as int8 dots
    (V stored int8 + scale; same quantization contract as
    `mu_update_frobenius_int8x8`). Each half-step quantizes its factor
    operand ONCE and builds BOTH the Gram and the rhs from it
    (`_ls_terms_*_int8`) — the r×r solve is then the exact f32 solution
    of the quantized least-squares problem, avoiding the cond²
    amplification of an exact-Gram/quantized-rhs mixture."""
    Vq = jnp.asarray(Vq)
    r = W.shape[1]

    def solve(gram, rhs, shift, off):
        A = gram + (shift + eps) * jnp.eye(r, dtype=gram.dtype)
        if off:
            A = A + off * jnp.ones((r, r), gram.dtype)
        return jnp.maximum(
            spd_solve(A, rhs), 0.0
        )

    def upd_w(W, H):
        gram, rhs = _ls_terms_w_int8(Vq, scale_v, H)   # (r, r), (r, n)
        return solve(gram, rhs, shift_w, off_w).T

    def upd_h(W, H):
        gram, rhs = _ls_terms_h_int8(Vq, scale_v, W)   # (r, r), (r, m)
        return solve(gram, rhs, shift_h, off_h)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def gdcls_update_int8x8(Vq, scale_v, W, H, lambda_tik=0.0, eps=1e-9,
                        order="WH"):
    """GDCLS with int8-stored V: MU-style W step and Tikhonov H solve,
    both rhs contractions as int8 dots. The H solve uses the
    consistent quantized Gram (see `als_family_update_int8x8`)."""
    Vq = jnp.asarray(Vq)
    r = W.shape[1]

    def upd_w(W, H):
        numer = _rhs_vht_int8(Vq, scale_v, H)
        return W * (numer / (W @ gram_rows(H) + eps))

    def upd_h(W, H):
        gram, rhs = _ls_terms_h_int8(Vq, scale_v, W)
        A = gram + (lambda_tik + eps) * jnp.eye(r, dtype=gram.dtype)
        return jnp.maximum(
            spd_solve(A, rhs), 0.0
        )

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def nsnmf_update_frobenius_int8x8(Vq, scale_v, W, H, S, eps=1e-9,
                                  order="WH"):
    """nsNMF (Frobenius) with int8-stored V: MU against the smoothed
    partners (S@H for the W step, W@S for the H step)."""
    Vq = jnp.asarray(Vq)

    def upd_w(W, H):
        SH = S @ H
        numer = _rhs_vht_int8(Vq, scale_v, SH)
        return W * (numer / (W @ gram_rows(SH) + eps))

    def upd_h(W, H):
        WS = W @ S
        numer = _rhs_wtv_int8(Vq, scale_v, WS)
        return H * (numer / (gram_cols(WS) @ H + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


# ---------------------------------------------------------------------------
# Weighted (implicit-feedback confidence) MU — BASELINE.json config #3
# ---------------------------------------------------------------------------


def mu_update_frobenius_weighted(V, C, W, H, eps=1e-9, order="WH"):
    """Confidence-weighted MU: minimizes || sqrt(C) * (V - WH) ||_F^2.

    C is an elementwise confidence matrix (e.g. 1 + alpha * clicks). Updates:
        W <- W * ((C*V) H^T) / ((C*(WH)) H^T + eps)
        H <- H * (W^T (C*V)) / (W^T (C*(WH)) + eps)
    """
    CV = C * V

    def upd_w(W, H):
        CWH = C * (W @ H)
        return W * ((CV @ H.T) / (CWH @ H.T + eps))

    def upd_h(W, H):
        CWH = C * (W @ H)
        return H * ((W.T @ CV) / (W.T @ CWH + eps))

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


# ---------------------------------------------------------------------------
# ALS family (SURVEY.md C4–C6): tiny r x r normal-equation solves + clamp
# ---------------------------------------------------------------------------


def spd_solve(A, rhs):
    """Solve A X = rhs for SPD r×r A (SURVEY.md C14).

    Cholesky once, triangular-solve only against the r-wide identity
    (the narrowest substitution), form A⁻¹ = L⁻ᵀL⁻¹, and apply it to the
    wide (r, n) rhs as one GEMM instead of a wide substitution.
    Numerically equivalent to the direct solve (error ~cond·eps either
    way — Newton–Schulz would be cheaper again but collapses above
    cond 1e3, so not used). A⁻¹ is built and applied at full precision:
    the solution inherits the product's rounding times cond(A)."""
    r = A.shape[-1]
    L = jax.lax.linalg.cholesky(A)
    Linv = jax.lax.linalg.triangular_solve(
        L, jnp.eye(r, dtype=A.dtype), lower=True, left_side=True
    )
    return jnp.matmul(gram_cols(Linv), rhs, precision=HIGHEST)


def solve_clamped(gram, rhs, shift, off, eps):
    """ALS-family normal-equation solve: Gram + diagonal shift
    (+ optional AHCLS off-diagonal 11ᵀ shift), spd_solve, clamp at 0.
    The one shared implementation for every engine (dense/scatter/ELL/
    densified/grid/ring) — fix conditioning here, not in five copies."""
    r = gram.shape[0]
    A = gram + (shift + eps) * jnp.eye(r, gram.shape[1], dtype=gram.dtype)
    if off:
        A = A + off * jnp.ones((r, r), gram.dtype)
    return jnp.maximum(spd_solve(A, rhs), 0.0)


def _solve_h(gram, rhs, eps):
    """Solve (gram + eps*I) H = rhs for H (r x m), symmetric positive shift."""
    r = gram.shape[0]
    A = gram + eps * jnp.eye(r, dtype=gram.dtype)
    return spd_solve(A, rhs)


def _batched_solve_clamped(Gb, rhs, shift, eps):
    """Per-row solves (b, r, r) x (b, r) -> clamp(>=0) (b, r).

    The eps ridge is SCALE-AWARE (eps · mean diagonal per row): weighted
    Grams can be huge (c up to 1+α·v) AND numerically singular (e.g. a
    constant init makes H C Hᵀ rank-1), where an absolute 1e-9 shift
    underflows f32 Cholesky into NaNs; relative eps keeps the solve
    finite without meaningfully perturbing well-posed rows."""
    r = Gb.shape[-1]
    diag_mean = jnp.trace(Gb, axis1=-2, axis2=-1)[:, None, None] / r
    # the relative floor must clear Cholesky's cancellation noise
    # (~machine-eps * scale), or a rank-deficient Gram (constant init!)
    # produces a negative pivot -> NaN factors
    rel_floor = 100.0 * jnp.finfo(Gb.dtype).eps
    ridge = shift + eps + jnp.maximum(eps, rel_floor) * diag_mean
    A = Gb + ridge * jnp.eye(r, dtype=Gb.dtype)[None]
    sol = jax.vmap(spd_solve)(A, rhs[..., None])[..., 0]
    return jnp.maximum(sol, 0.0)


def _batched_solve_clamped_cg(Gb, rhs, shift, eps, x0, steps=3):
    """Warm-started Jacobi-preconditioned CG for the per-row normal
    equations of weighted/masked ALS, then clamp(>=0).

    A batched Cholesky is sequential over the factorization steps.
    Each CG step is one batched (n, r, r) @ (n, r) matvec — pure
    memory bandwidth — and because the OUTER ALS loop is itself iterative,
    warm-starting from the previous factors makes a handful of inner
    steps sufficient (Takács & Pilászy 2011, ALS-CG): the sequence
    converges to the same fixed point, tested against the exact path.

    The clamp projects after the solve exactly like the exact path
    (the reference ALS family's clamp semantics), so negative
    unconstrained solutions zero identically under both solvers.
    """
    r = Gb.shape[-1]
    diag_mean = jnp.trace(Gb, axis1=-2, axis2=-1)[:, None, None] / r
    rel_floor = 100.0 * jnp.finfo(Gb.dtype).eps
    ridge = shift + eps + jnp.maximum(eps, rel_floor) * diag_mean
    A = Gb + ridge * jnp.eye(r, dtype=Gb.dtype)[None]
    dinv = 1.0 / jnp.maximum(
        jnp.diagonal(A, axis1=-2, axis2=-1), jnp.finfo(A.dtype).tiny
    )                                                     # (n, r) Jacobi

    def matvec(p):
        return jnp.einsum("nij,nj->ni", A, p)

    x = x0.astype(A.dtype)
    res = rhs - matvec(x)
    z = dinv * res
    p = z
    rz = jnp.sum(res * z, axis=1, keepdims=True)

    def body(_, c):
        x, res, p, rz = c
        Ap = matvec(p)
        denom = jnp.sum(p * Ap, axis=1, keepdims=True)
        alpha = rz / jnp.where(denom > 0, denom, 1.0)
        alpha = jnp.where(denom > 0, alpha, 0.0)  # converged rows freeze
        x = x + alpha * p
        res = res - alpha * Ap
        z = dinv * res
        rz2 = jnp.sum(res * z, axis=1, keepdims=True)
        beta = rz2 / jnp.where(rz > 0, rz, 1.0)
        p = z + jnp.where(rz > 0, beta, 0.0) * p
        return x, res, p, rz2

    x, *_ = lax.fori_loop(0, steps, body, (x, res, p, rz))
    return jnp.maximum(x, 0.0)


def als_update_weighted(V, W, H, alpha, lambda_w=0.0, lambda_h=0.0,
                        eps=1e-9, order="WH", block=1024):
    """Confidence-weighted ALS (iALS, Hu–Koren–Volinsky) with the
    library's weighting convention C = 1 + alpha * V: each half-step
    solves every row's EXACT weighted normal equations

        (H C_u Hᵀ + (λ+eps) I) w_u = H (c_u ⊙ v_u)

    (and the column dual for H), then clamps at 0 — the same objective
    ‖√C ⊙ (V − WH)‖² + λ‖·‖² as `mu_update_frobenius_weighted`, but an
    exact alternating minimizer instead of multiplicative steps.

    Per-row Grams are built panel-blocked (`block` rows/cols at a time:
    one (block, r, r) einsum + one batched Cholesky), so the
    O(n r²) Gram storage never materializes at full size. Cost per
    half-step: O(n m r² / panel-free) FLOPs on dense V — for sparse
    inputs use the sparse-aware twin (sparse_ops.als_update_weighted_
    sparse), which pays O(nnz r²) instead.
    """
    n, m = V.shape
    r = W.shape[1]

    def upd_w(W, H):
        Ht = H.T

        def panel(start, rows, out):
            Vp = lax.dynamic_slice_in_dim(V, start, rows, 0)
            Cp = 1.0 + alpha * Vp
            Gb = jnp.einsum("rm,um,sm->urs", H, Cp, H)
            rhs = (Cp * Vp) @ Ht
            Wp = _batched_solve_clamped(Gb, rhs, lambda_w, eps)
            return lax.dynamic_update_slice_in_dim(out, Wp, start, 0)

        nb, tail = divmod(n, block)
        out = jnp.zeros((n, r), V.dtype)
        if nb:
            out = lax.fori_loop(
                0, nb, lambda i, o: panel(i * block, block, o), out
            )
        if tail:
            out = panel(nb * block, tail, out)
        return out

    def upd_h(W, H):
        def panel(start, cols, out):
            Vp = lax.dynamic_slice_in_dim(V, start, cols, 1)
            Cp = 1.0 + alpha * Vp
            Gb = jnp.einsum("nr,nu,ns->urs", W, Cp, W)
            rhs = (Cp * Vp).T @ W                       # (cols, r)
            Hp = _batched_solve_clamped(Gb, rhs, lambda_h, eps)
            return lax.dynamic_update_slice_in_dim(out, Hp.T, start, 1)

        nb, tail = divmod(m, block)
        out = jnp.zeros((r, m), V.dtype)
        if nb:
            out = lax.fori_loop(
                0, nb, lambda i, o: panel(i * block, block, o), out
            )
        if tail:
            out = panel(nb * block, tail, out)
        return out

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def _hals_half_sweep(XHt, G, W):
    """One cyclic HALS sweep over the r columns of W:

        W[:, t] <- max(W[:, t] - (W G[:, t] - XHt[:, t]) / G[t, t], 0)

    sequentially in t (each column sees the already-updated earlier
    columns) — bit-for-bit the update of sklearn's coordinate-descent
    solver (`_cdnmf_fast._update_cdnmf_fast` with the identity
    permutation). XHt (n, r) and the Gram G (r, r) are precomputed, so
    V is never touched inside the sweep: the same function serves the
    dense, sparse, and sharded engines."""
    r = G.shape[0]

    def col(t, W):
        g_col = lax.dynamic_slice_in_dim(G, t, 1, 1)[:, 0]     # (r,)
        x_col = lax.dynamic_slice_in_dim(XHt, t, 1, 1)[:, 0]   # (n,)
        w_col = lax.dynamic_slice_in_dim(W, t, 1, 1)[:, 0]
        grad = jnp.matmul(W, g_col, precision=HIGHEST) - x_col
        hess = g_col[t]
        new = jnp.maximum(w_col - grad / jnp.where(hess != 0, hess, 1.0),
                          0.0)
        new = jnp.where(hess != 0, new, w_col)  # sklearn skips hess==0
        return lax.dynamic_update_slice_in_dim(
            W, new[:, None], t, 1
        )

    return lax.fori_loop(0, r, col, W)


def _hals_half_sweep_blocked(XHt, G, W, block=32):
    """Blocked Gauss–Seidel HALS sweep — the SAME sequential column
    ordering as `_hals_half_sweep` (each column sees every earlier
    updated column), restructured into few large steps:

    * columns are processed in blocks of `block`; the gradient base for
      a whole block is ONE (n, r) @ (r, block) GEMM instead of
      `block` dependent matvecs against the full W;
    * within a block the exact cyclic ordering is preserved by rank-1
      corrections: after column t changes by delta, every later
      column's gradient shifts by delta * G[t, s], applied as one
      (n, block) outer-product add.

    Identical update in exact arithmetic; differs from the sequential
    sweep only in summation order (f32 roundoff), which the parity
    tests bound. Same math as sklearn's Cython `_update_cdnmf_fast`
    inner loop, blocked. The base GEMM runs at HIGHEST precision: the
    sweep is sequential, so TF32 rounding would compound across blocks.
    A Triton kernel that ran the whole half-sweep in one launch was
    slower than this form on the H100 (PERF.md).
    """
    n, r = W.shape
    block = min(block, r)
    nb, tail = divmod(r, block)

    def do_block(W, start, b):
        Gb = lax.dynamic_slice_in_dim(G, start, b, 1)        # (r, b)
        Xb = lax.dynamic_slice_in_dim(XHt, start, b, 1)      # (n, b)
        base = jnp.matmul(W, Gb, precision=HIGHEST) - Xb     # (n, b)
        Wb = lax.dynamic_slice_in_dim(W, start, b, 1)        # (n, b)
        Gbb = lax.dynamic_slice_in_dim(Gb, start, b, 0)      # (b, b)

        # The within-block loop is UNROLLED (static t): the whole
        # b-step dependency chain compiles to one fused elementwise
        # program with no per-step loop dispatch — the sweep's
        # sequential XLA steps drop from r to r/b.
        new_cols = []
        for t in range(b):
            hess = Gbb[t, t]
            w_col = Wb[:, t]
            grad = base[:, t]
            new = jnp.maximum(
                w_col - grad / jnp.where(hess != 0, hess, 1.0), 0.0)
            new = jnp.where(hess != 0, new, w_col)
            delta = new - w_col
            # Shift the gradients of the not-yet-visited columns; cols
            # <= t are corrected too but never read again.
            base = base + delta[:, None] * Gbb[t][None, :]
            new_cols.append(new)
        Wb = jnp.stack(new_cols, axis=1)
        return lax.dynamic_update_slice_in_dim(W, Wb, start, 1)

    if nb:
        W = lax.fori_loop(
            0, nb, lambda i, W: do_block(W, i * block, block), W)
    if tail:
        W = do_block(W, nb * block, tail)
    return W


def hals_half_sweep(XHt, G, W, block=16):
    """One HALS half-sweep: the blocked sweep (`_hals_half_sweep_blocked`),
    or the strictly sequential one below rank 16, where a block would
    cover the whole factor. Both are the same update in exact
    arithmetic, bounded in f32 by the parity tests."""
    if G.shape[0] < 16:
        return _hals_half_sweep(XHt, G, W)
    return _hals_half_sweep_blocked(XHt, G, W, block=block)


def hals_update(V, W, H, eps=1e-9, order="WH", l2_w=0.0, l2_h=0.0,
                l1_w=0.0, l1_h=0.0, block=16):
    # NOTE: eps is accepted for registry-signature uniformity but unused —
    # the division is guarded by the hess != 0 branch (sklearn semantics).
    # Regularization follows sklearn's _update_coordinate_descent exactly:
    # L2 adds to the Gram diagonal, L1 subtracts from the numerator.
    """HALS / coordinate descent (Cichocki & Phan; sklearn's DEFAULT
    'cd' solver): per-iteration, one cyclic rank-1 sweep over W's
    columns then one over H's rows. Same O(nmr) GEMMs as MU for the
    numerators plus O((n+m) r²) column work; typically converges in
    far fewer iterations than MU. Frobenius objective only.

    `block` selects the sweep implementation: block=1 is the strictly
    sequential per-column sweep (the semantic oracle); block>1
    dispatches through `hals_half_sweep` (the blocked XLA sweep) — the
    same column ordering, f32-roundoff-equivalent."""
    r = W.shape[1]
    eye = jnp.eye(r, dtype=W.dtype)
    if block > 1:
        half = lambda XHt, G, W: hals_half_sweep(XHt, G, W, block=block)
    else:
        half = _hals_half_sweep

    def sweep_w(W, H):
        G = gram_rows(H) + l2_w * eye
        return half(V @ H.T - l1_w, G, W)

    def sweep_h(W, H):
        G = gram_cols(W) + l2_h * eye
        return half(V.T @ W - l1_h, G, H.T).T

    if order == "WH":
        W = sweep_w(W, H)
        H = sweep_h(W, H)
    else:
        H = sweep_h(W, H)
        W = sweep_w(W, H)
    return W, H


def _rhs(A, B):
    """An ALS-family right-hand side at full precision: the solve
    amplifies its rounding by the Gram's condition number."""
    return jnp.matmul(A, B, precision=HIGHEST)


def als_update(V, W, H, eps=1e-9, order="WH"):
    """ALS iteration: exact LS via normal equations, then clamp to >= 0.

    H = max(0, (W^T W)^-1 W^T V);  W likewise from (H H^T). The solve is r x r
    (SURVEY.md C14) — negligible next to the O(nmr) right-hand-side GEMMs.
    """

    def upd_w(W, H):
        Wt = _solve_h(gram_rows(H), _rhs(H, V.T), eps)     # (r, n)
        return jnp.maximum(Wt.T, 0.0)

    def upd_h(W, H):
        Ht = _solve_h(gram_cols(W), _rhs(W.T, V), eps)     # (r, m)
        return jnp.maximum(Ht, 0.0)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def acls_update(V, W, H, lambda_w=0.0, lambda_h=0.0, eps=1e-9, order="WH"):
    """ACLS (Langville et al.): ALS with sparsity penalties on the diagonal.

    Solves (W^T W + lambda_h I) H = W^T V and the dual for W, then clamps.
    """

    def upd_w(W, H):
        Wt = _solve_h(gram_rows(H), _rhs(H, V.T), lambda_w + eps)
        return jnp.maximum(Wt.T, 0.0)

    def upd_h(W, H):
        Ht = _solve_h(gram_cols(W), _rhs(W.T, V), lambda_h + eps)
        return jnp.maximum(Ht, 0.0)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def _ahcls_shift(lam, alpha, r, dtype):
    """AHCLS diagonal/off-diagonal shift from a Hoyer-sparseness target.

    Following Langville et al.'s AHCLS: the normal-equation matrix becomes
    G + lam * beta * I + lam * (1 - beta) * 11^T  with
    beta = ((1 - alpha) * sqrt(r) + alpha)^2 / r, alpha the desired
    sparseness in [0, 1].
    """
    sr = jnp.sqrt(jnp.asarray(float(r), dtype=dtype))
    beta = ((1.0 - alpha) * sr + alpha) ** 2 / r
    diag = lam * beta
    off = lam * (1.0 - beta)
    return diag, off


def ahcls_update(
    V, W, H, lambda_w=0.0, lambda_h=0.0, alpha_w=0.5, alpha_h=0.5,
    eps=1e-9, order="WH",
):
    """AHCLS: ACLS plus Hoyer-sparseness targets alpha_w / alpha_h."""
    r = W.shape[1]
    dt = V.dtype
    ones = jnp.ones((r, r), dtype=dt)

    def upd_w(W, H):
        diag, off = _ahcls_shift(lambda_w, alpha_w, r, dt)
        A = gram_rows(H) + (diag + eps) * jnp.eye(r, dtype=dt) + off * ones
        Wt = spd_solve(A, _rhs(H, V.T))
        return jnp.maximum(Wt.T, 0.0)

    def upd_h(W, H):
        diag, off = _ahcls_shift(lambda_h, alpha_h, r, dt)
        A = gram_cols(W) + (diag + eps) * jnp.eye(r, dtype=dt) + off * ones
        Ht = spd_solve(A, _rhs(W.T, V))
        return jnp.maximum(Ht, 0.0)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


def gdcls_update(V, W, H, lambda_tik=0.0, eps=1e-9, order="WH"):
    """GDCLS hybrid: MU (Frobenius) step for W, Tikhonov-regularized LS for H."""

    def upd_w(W, H):
        return mu_update_w_frobenius(V, W, H, eps)

    def upd_h(W, H):
        Ht = _solve_h(gram_cols(W), _rhs(W.T, V), lambda_tik + eps)
        return jnp.maximum(Ht, 0.0)

    if order == "WH":
        W = upd_w(W, H)
        H = upd_h(W, H)
    else:
        H = upd_h(W, H)
        W = upd_w(W, H)
    return W, H


# ---------------------------------------------------------------------------
# nsNMF (SURVEY.md C7)
# ---------------------------------------------------------------------------


def nsnmf_smoothing_matrix(rank, theta, dtype=jnp.float32):
    """S = (1 - theta) I + (theta / r) 11^T  — the nsNMF smoothing matrix."""
    eye = jnp.eye(rank, dtype=dtype)
    ones = jnp.ones((rank, rank), dtype=dtype)
    return (1.0 - theta) * eye + (theta / rank) * ones


def nsnmf_update(V, W, H, S, eps=1e-9, objective="frobenius", order="WH"):
    """One nsNMF iteration: MU updates against the smoothed partners.

    V ~ W S H; W is updated with (S H) standing in for H, and H with (W S)
    standing in for W (Pascual-Montano 2006).
    """
    if objective == "frobenius":
        upd_w = mu_update_w_frobenius
        upd_h = mu_update_h_frobenius
    else:
        upd_w = mu_update_w_kl
        upd_h = mu_update_h_kl

    if order == "WH":
        W = upd_w(V, W, S @ H, eps)
        H = upd_h(V, W @ S, H, eps)
    else:
        H = upd_h(V, W @ S, H, eps)
        W = upd_w(V, W, S @ H, eps)
    return W, H


# ---------------------------------------------------------------------------
# Error metrics (SURVEY.md C9) — no host round-trips, reusable inside
# lax.while_loop carries.
# ---------------------------------------------------------------------------


def frobenius_error_sq(V, W, H, sum_v_sq=None):
    """||V - WH||_F^2 via the Gram/trace identity.

    ||V - WH||^2 = ||V||^2 - 2 tr(H^T (W^T V)) + tr((W^T W)(H H^T)).
    Avoids materializing WH when V is large; the only O(nmr) term is W^T V.
    `sum_v_sq` (= ||V||_F^2) can be precomputed once outside the loop.
    """
    if sum_v_sq is None:
        sum_v_sq = jnp.sum(V * V)
    WtV = jnp.matmul(W.T, V, precision=HIGHEST)   # (r, m)
    cross = jnp.sum(WtV * H)
    WtW = gram_cols(W)
    HHt = gram_rows(H)
    quad = jnp.sum(WtW * HHt)
    # Clamp: the identity can go slightly negative in floating point near
    # convergence.
    return jnp.maximum(sum_v_sq - 2.0 * cross + quad, 0.0)


def frobenius_error(V, W, H, sum_v_sq=None):
    """||V - WH||_F."""
    return jnp.sqrt(frobenius_error_sq(V, W, H, sum_v_sq))


def rmsd(V, W, H, sum_v_sq=None):
    """Root-mean-square deviation: sqrt(||V - WH||_F^2 / (n m))."""
    n, m = V.shape[0], H.shape[1]
    return jnp.sqrt(frobenius_error_sq(V, W, H, sum_v_sq) / (float(n) * float(m)))


def kl_error(V, W, H, eps=1e-12):
    """Generalized KL (I-)divergence D(V || WH) = sum V log(V/WH) - V + WH.

    Zero entries of V contribute only their +WH term (lim x->0 x log x = 0),
    matching sklearn's beta_divergence(beta=1) up to the eps guard.
    """
    WH = jnp.matmul(W, H, precision=HIGHEST)
    ratio_term = jnp.where(
        V > 0, V * (jnp.log(jnp.maximum(V, eps) / jnp.maximum(WH, eps))), 0.0
    )
    return jnp.sum(ratio_term - V + WH)


def beta_divergence(V, W, H, beta, eps=1e-12):
    """Generalized beta divergence D_beta(V || WH), sklearn's
    _beta_divergence general/IS branches (without the square_root):

      beta=0 (IS):  sum  V/WH - log(V/WH) - 1
      otherwise:    sum (V^b + (b-1) WH^b - b V WH^(b-1)) / (b (b-1))

    WH is eps-guarded; for beta <= 0 zero entries of V are eps-guarded
    too (the IS divergence is +inf at V=0 — sklearn reports inf there;
    we report the finite eps-proxy so best-of-N stays comparable).
    The specialized beta=1/beta=2 objectives use kl_error /
    frobenius_error instead.
    """
    WH = jnp.maximum(W @ H, eps)
    if beta == 0.0:
        div = jnp.maximum(V, eps) / WH
        return jnp.sum(div - jnp.log(div) - 1.0)
    if beta <= 0.0:
        Vb = jnp.maximum(V, eps) ** beta
    else:
        Vb = jnp.where(V > 0, V, 1.0) ** beta
        Vb = jnp.where(V > 0, Vb, 0.0)
    term = Vb + (beta - 1.0) * WH ** beta - beta * V * WH ** (beta - 1.0)
    return jnp.sum(term) / (beta * (beta - 1.0))
