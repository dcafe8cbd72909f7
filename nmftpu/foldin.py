"""Fold-in / out-of-sample projection: user factors for NEW interaction
rows against a FIXED item table H.

The reference's only warm-start mechanism is ``CopyExisting`` init
(SURVEY.md C8/§5.4) — serving a user that appeared after training means
re-running the factorization. This module completes the serving story:
``transform(V_new, H)`` learns only the (b, r) user block, with H frozen,
so cold users get embeddings in milliseconds without touching the trained
item table. The semantics match sklearn's ``NMF.transform`` (MU with
``update_H=False``, ``sklearn/decomposition/_nmf.py:532`` — the oracle for
the parity tests).

Shape of the problem: with H fixed, the MU-Frobenius numerator
``V Hᵀ`` and the Gram ``H Hᵀ`` are loop-invariant — both are hoisted and
the iteration body is two tiny ``(b,r)×(r,r)`` GEMMs. Sparse inputs
never materialize dense rows OR a full table read: numerators touch only
the gathered columns ``Ht[cols]`` (at a 10M-item table that is the
difference between kilobytes and a 10 GB read per fold-in).

Algorithms:
  * ``mu``  — multiplicative updates, Frobenius or KL objective.
  * ``als`` — one-shot regularized nonnegative LS (normal equations via
    ``linalg.dense.spd_solve`` + clamp); with ``alpha_confidence`` this is
    the classic implicit-feedback weighted fold-in
    (Gram_u = HHᵀ + Σ_obs (c_i−1) h_i h_iᵀ, matching the training
    objective ``‖√C ⊙ (V−WH)‖²`` of mu_update_frobenius_weighted).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from nmftpu.linalg.dense import gram_cols
from nmftpu.sparse import SparseMatrix


@dataclasses.dataclass(frozen=True)
class TransformResult:
    """Learned user block for a fixed item table."""

    W: np.ndarray  # (b, rank) nonnegative user factors
    error: float  # objective at exit (Frobenius norm, or KL divergence)
    rmsd: float  # Frobenius objective only; NaN for KL
    num_iterations: int


@dataclasses.dataclass(frozen=True)
class PreparedTable:
    """Loop-invariant per-table quantities for repeated fold-ins.

    Per-request serving (Recommender.fold_in) must not rebuild the
    O(r²m) Gram and the (m, r) transpose on every call; prepare once
    with :func:`prepare_table` and pass the result as ``transform``'s
    ``H``. ``Ht`` keeps the TABLE's dtype (a bf16 serving table is
    never up-cast in full — only the gathered history columns are);
    the (r, r)/(r,) statistics accumulate in f32.
    """

    Ht: Any     # (m, r) item table, original dtype (int8 with `scale`)
    G: Any      # (r, r) f32 Gram H Hᵀ (scale folded in)
    h_sum: Any  # (r,) f32 row sums (KL denominator; scale folded in)
    # int8 tables: true H = scale * Ht.T (scalar) or
    # diag(scale) @ Ht.T ((r,) per-dimension vector)
    scale: Any = None

    @property
    def shape(self):
        m, r = self.Ht.shape
        return r, m


def prepare_table(H, scale=None) -> PreparedTable:
    """Precompute the table-invariant fold-in quantities once.

    scale: for an int8-quantized table — a SCALAR (true H = scale *
    H_int8) or a (rank,) VECTOR of per-dimension scales (true H =
    diag(scale) @ H_int8, the serving default). The Gram/row-sum
    statistics fold the scale in, and gathers up-cast + scale only the
    observed columns (a (nnz, r) gather broadcasts against the (r,)
    vector directly)."""
    H = jnp.asarray(H)
    if H.ndim != 2:
        raise ValueError(f"H must be (rank, n_items), got shape {H.shape}")
    Ht = H.T  # (m, r): gathers whole rows

    def fold(G, h_sum, sc):
        sc = jnp.asarray(sc, jnp.float32)
        if sc.ndim == 1:
            return G * (sc[:, None] * sc[None, :]), h_sum * sc, sc
        return G * (sc * sc), h_sum * sc, float(sc)

    if jnp.issubdtype(H.dtype, jnp.integer):
        if scale is None:
            raise ValueError("an integer table needs its quantization "
                             "scale")
        Hb = H.astype(jnp.bfloat16)  # int8 -> bf16 exact
        G = jax.lax.dot_general(
            Hb, Hb.T, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        h_sum = jnp.sum(H, axis=1, dtype=jnp.float32)
        G, h_sum, sc = fold(G, h_sum, scale)
        return PreparedTable(Ht=Ht, G=G, h_sum=h_sum, scale=sc)
    G = jax.lax.dot_general(
        H, Ht, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    h_sum = jnp.sum(H, axis=1, dtype=jnp.float32)
    if scale is not None:
        G, h_sum, sc = fold(G, h_sum, scale)
        return PreparedTable(Ht=Ht, G=G, h_sum=h_sum, scale=sc)
    return PreparedTable(Ht=Ht, G=G, h_sum=h_sum)


# ---------------------------------------------------------------------------
# Jitted W-only loops (numerator inputs hoisted outside the fori_loop)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(3,))
def _mu_fro_w_loop(N, G, W0, num_iterations, eps):
    """W ← W ⊙ N / (W G + eps), k times. N=(b,r), G=(r,r) loop-invariant."""

    def body(_, W):
        return W * (N / (W @ G + eps))

    return jax.lax.fori_loop(0, num_iterations, body, W0)


@partial(jax.jit, static_argnums=(3, 4))
def _beta_w_loop_dense(V, H, W0, num_iterations, beta):
    """Generalized-beta projection: k W-only MU steps with H fixed
    (sklearn's transform semantics under a float beta_loss — the
    update, guards, gamma exponent and beta<1 stabilization are
    linalg.dense.beta_w_step / mu_update_beta's, W half only)."""
    from nmftpu.linalg import dense as D

    gamma = D.beta_gamma(beta)

    def body(_, W):
        W = D.beta_w_step(V, W, H, beta, gamma=gamma)
        if beta < 1.0:
            W = jnp.where(W < D._STAB_EPS, 0.0, W)
        return W

    return jax.lax.fori_loop(0, num_iterations, body, W0)


@partial(jax.jit, static_argnums=(4,))
def _mu_kl_w_loop_dense(V, Ht, h_sum, W0, num_iterations, eps):
    """KL: W ← W ⊙ ((V/(WH)) Hᵀ) / h_sum. Dense V (b, m)."""
    denom = h_sum[None, :] + eps

    def body(_, W):
        WH = W @ Ht.T
        return W * (((V / (WH + eps)) @ Ht) / denom)

    return jax.lax.fori_loop(0, num_iterations, body, W0)


@partial(jax.jit, static_argnums=(5, 7))
def _mu_kl_w_loop_sparse(vals, rows, Hc, h_sum, W0, num_iterations, eps,
                         num_rows):
    """KL on sparse rows: the reconstruction is sampled ONLY at the
    nonzeros (SDDMM over the gathered columns Hc = Ht[cols]); zero
    entries of V contribute nothing to the KL numerator."""
    denom = h_sum[None, :] + eps

    def body(_, W):
        pred = jnp.sum(W[rows] * Hc, axis=1)  # (nnz,) SDDMM sample
        ratio = vals / (pred + eps)
        numer = jax.ops.segment_sum(
            ratio[:, None] * Hc, rows, num_segments=num_rows
        )
        return W * (numer / denom)

    return jax.lax.fori_loop(0, num_iterations, body, W0)


# ---------------------------------------------------------------------------
# Input plumbing
# ---------------------------------------------------------------------------


def _flat_nnz(data: SparseMatrix):
    csr = data.to_csr()
    b, m = csr.shape
    counts = np.diff(csr.indptr).astype(np.int64)
    rows = np.repeat(np.arange(b, dtype=np.int32), counts)
    return rows, csr.indices.astype(np.int32), csr.data, csr.indptr, (b, m)


def _init_w(b, r, seed, W0, dtype):
    if W0 is not None:
        W = np.asarray(W0, dtype=np.float32)
        if W.shape != (b, r):
            raise ValueError(f"W0 must be shape {(b, r)}, got {W.shape}")
        if (W < 0).any():
            raise ValueError("W0 must be nonnegative")
        return jnp.asarray(W, dtype)
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(0.1, 1.0, (b, r)), dtype)


# ---------------------------------------------------------------------------
# Errors (Gram trick keeps sparse error evaluation off the dense m axis)
# ---------------------------------------------------------------------------


def _fro_error_sparse(vals, rows, Hc, W, G, sum_v_sq):
    """‖V−WH‖ via ⟨V,WH⟩ sampled at nonzeros + tr((WᵀW)(HHᵀ))."""
    pred = jnp.sum(W[rows] * Hc, axis=1)
    cross = jnp.sum(vals * pred)
    wtw = gram_cols(W)
    sq = sum_v_sq - 2.0 * cross + jnp.sum(wtw * G)
    return jnp.sqrt(jnp.maximum(sq, 0.0))


def _kl_error_sparse(vals, rows, Hc, W, h_sum, eps):
    """Σ_nz v·log(v/pred) − Σv + ΣWH (zero entries add only their WH mass)."""
    pred = jnp.sum(W[rows] * Hc, axis=1)
    pos = jnp.sum(vals * (jnp.log(vals + eps) - jnp.log(pred + eps)))
    return pos - jnp.sum(vals) + jnp.sum(W @ h_sum)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def transform(
    data,
    H,
    *,
    algorithm: str = "mu",
    objective: str = "frobenius",
    num_iterations: int = 100,
    eps: float = 1e-9,
    lambda_w: float = 0.0,
    alpha_confidence: float = 0.0,
    W0=None,
    seed: int = 0,
    beta: float | None = None,
) -> TransformResult:
    """Learn nonnegative user factors W for ``data`` ≈ W H with H FIXED.

    data: dense (b, m) array or any nmftpu sparse container with b rows.
    H: the trained (rank, m) item table (e.g. ``NmfResult.H``).
    algorithm: ``"mu"`` (iterative, Frobenius/KL objective) or ``"als"``
      (one-shot regularized LS + clamp; supports ``alpha_confidence``
      implicit weighting c = 1 + alpha·v).
    lambda_w: Tikhonov shift on the ALS normal equations.
    Returns TransformResult; rows with no interactions come back ~zero
    under every rule (the MU numerator for an empty row is 0, so its
    factors shrink to 0 over the iterations; ALS solves to exact zeros)
    — zero scores against any item table, i.e. "no information".
    """
    from nmftpu.linalg import dense as D

    # jnp.asarray keeps an already-on-device table resident (serving hands
    # us its jax H; a host round-trip at 10M items would dwarf the solve).
    # A PreparedTable (prepare_table) skips the per-call Gram/transpose.
    prep = H if isinstance(H, PreparedTable) else prepare_table(H)
    r, m = prep.shape
    dtype = jnp.float32
    Ht, G, h_sum = prep.Ht, prep.G, prep.h_sum

    if algorithm not in ("mu", "als", "hals"):
        raise ValueError(
            f"algorithm must be mu|als|hals, got {algorithm!r}"
        )
    if objective not in ("frobenius", "kl", "beta"):
        raise ValueError(
            f"objective must be frobenius|kl|beta, got {objective!r}"
        )
    if objective == "beta":
        if beta is None:
            raise ValueError("objective='beta' needs the beta value")
        # the specialized loops are both faster and guard-identical
        if beta == 2.0:
            objective = "frobenius"
        elif beta == 1.0:
            objective = "kl"
    if algorithm in ("als", "hals") and objective != "frobenius":
        raise ValueError(
            f"{algorithm} transform supports the frobenius objective"
        )
    if objective == "beta" and isinstance(data, SparseMatrix):
        raise ValueError(
            "generalized-beta transform needs dense rows (the "
            "denominator samples the full reconstruction); densify "
            "the batch or use objective='kl'/'frobenius'"
        )
    if alpha_confidence and algorithm != "als":
        raise ValueError(
            "alpha_confidence weighting requires algorithm='als'"
        )

    sparse_in = isinstance(data, SparseMatrix)
    b_in = data.shape[0] if hasattr(data, "shape") else len(data)
    if b_in == 0:  # empty batch (e.g. an empty serving request)
        return TransformResult(
            W=np.zeros((0, r), np.float32), error=0.0,
            rmsd=float("nan") if objective == "kl" else 0.0,
            num_iterations=0,
        )
    if sparse_in:
        rows_np, cols_np, vals_np, indptr_np, (b, m_in) = _flat_nnz(data)
        if m_in != m:
            raise ValueError(
                f"data has {m_in} columns but H has {m} items"
            )
        if cols_np.size:
            # the gather below promises in-bounds indices — a bad item id
            # from a serving caller must fail here, not read garbage
            lo, hi = int(cols_np.min()), int(cols_np.max())
            if lo < 0 or hi >= m:
                raise ValueError(
                    f"item index out of range: [{lo}, {hi}] vs {m} items"
                )
        if vals_np.size and float(vals_np.min()) < 0:
            raise ValueError("data must be nonnegative")
        rows = jnp.asarray(rows_np)
        vals = jnp.asarray(vals_np, dtype)
        # only the observed columns of the table are ever read
        # (row gather from the (m, r) table — PERF.md's fastest form);
        # a bf16/int8 serving table up-casts only these gathered rows
        Hc = Ht.at[jnp.asarray(cols_np)].get(
            mode="promise_in_bounds"
        ).astype(dtype)  # (nnz, r)
        if prep.scale is not None:
            Hc = Hc * prep.scale
        N = jax.ops.segment_sum(vals[:, None] * Hc, rows, num_segments=b)
        sum_v_sq = jnp.sum(vals * vals)
    else:
        if prep.scale is not None:
            raise ValueError(
                "dense fold-in against a quantized table is not "
                "supported — pass sparse data (serving histories), or "
                "dequantize the table first"
            )
        V = jnp.asarray(np.asarray(data, dtype=np.float32))
        if V.ndim != 2 or V.shape[1] != m:
            raise ValueError(f"data must be (b, {m}), got {V.shape}")
        if bool(jnp.any(V < 0)):
            raise ValueError("data must be nonnegative")
        b = V.shape[0]
        N = jax.lax.dot_general(
            V.astype(Ht.dtype), Ht,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        sum_v_sq = jnp.sum(V * V)

    if algorithm == "als":
        if alpha_confidence:
            if not sparse_in:
                H32 = Ht.T.astype(dtype)
                C = 1.0 + alpha_confidence * V
                # per-user Gram Hᵀ diag(C_u) H, batched
                Gb = jnp.einsum("rm,um,sm->urs", H32, C, H32)
                rhs = (C * V) @ H32.T  # (b, r)
            else:
                Gb, rhs = _weighted_grams_sparse(
                    G, Ht, cols_np, vals_np, indptr_np, b,
                    alpha_confidence, h_scale=prep.scale,
                )
            # scale-aware ridge (see linalg.dense._batched_solve_clamped):
            # weighted Grams can be large and near-singular; an absolute
            # 1e-9 shift sits below f32 Cholesky cancellation noise
            W = D._batched_solve_clamped(
                Gb.astype(jnp.float32), rhs.astype(jnp.float32),
                lambda_w, eps,
            ).astype(dtype)
        else:
            A = G.astype(dtype) + (lambda_w + eps) * jnp.eye(
                r, dtype=dtype
            )
            W = jnp.maximum(D.spd_solve(A, N.T).T, 0.0)
        iters_done = 1
    elif algorithm == "hals":
        # W-only cyclic column sweeps against the frozen table — the
        # projection twin of Algorithm.HALS (sklearn's 'cd' transform):
        # XHt and the Gram are loop-invariant, so each iteration is one
        # _hals_half_sweep.
        W0d = _init_w(b, r, seed, W0, dtype)
        Gh = G.astype(dtype) + lambda_w * jnp.eye(r, dtype=dtype)
        Nf = N.astype(dtype)
        W = jax.lax.fori_loop(
            0, num_iterations,
            lambda _, Wc: D.hals_half_sweep(Nf, Gh, Wc), W0d,
        )
        iters_done = num_iterations
    elif objective == "beta":
        W0d = _init_w(b, r, seed, W0, dtype)
        W = _beta_w_loop_dense(V, Ht.T.astype(dtype), W0d,
                               num_iterations, float(beta))
        iters_done = num_iterations
    elif objective == "frobenius":
        W0d = _init_w(b, r, seed, W0, dtype)
        W = _mu_fro_w_loop(N, G, W0d, num_iterations, eps)
        iters_done = num_iterations
    else:  # mu / kl
        W0d = _init_w(b, r, seed, W0, dtype)
        if sparse_in:
            W = _mu_kl_w_loop_sparse(
                vals, rows, Hc, h_sum, W0d, num_iterations, eps, b
            )
        else:
            W = _mu_kl_w_loop_dense(V, Ht.astype(dtype), h_sum, W0d,
                                    num_iterations, eps)
        iters_done = num_iterations

    # exit-time objective
    if objective == "beta":
        err = float(D.beta_divergence(V, W, Ht.T.astype(dtype),
                                      float(beta)))
        rmsd = float("nan")
    elif objective == "kl":
        if sparse_in:
            err = float(_kl_error_sparse(vals, rows, Hc, W, h_sum, 1e-12))
        else:
            err = float(D.kl_error(V, W, Ht.T.astype(dtype)))
        rmsd = float("nan")
    else:
        if sparse_in:
            err = float(_fro_error_sparse(vals, rows, Hc, W, G, sum_v_sq))
        else:
            err = float(D.frobenius_error(V, W, Ht.T.astype(dtype),
                                          sum_v_sq=sum_v_sq))
        rmsd = err / float(np.sqrt(b * m))
    return TransformResult(
        W=np.asarray(W), error=err, rmsd=rmsd, num_iterations=iters_done
    )


def _weighted_grams_sparse(G, Ht, cols_np, vals_np, indptr_np, b, alpha,
                           h_scale=None):
    """Batched per-user weighted Grams from CSR structure.

    Pads each user's items to the batch max (fold-in batches are small and
    histories bounded, so the (b, kmax, r) gather stays tiny) and forms
      Gram_u = HHᵀ + Σ_i (c_i − 1) h_i h_iᵀ,   rhs_u = Σ_i c_i v_i h_i
    with c = 1 + alpha·v; unobserved entries (v=0, c=1) contribute only
    through the shared HHᵀ term.
    """
    counts = np.diff(indptr_np)
    kmax = max(int(counts.max()) if len(counts) else 0, 1)
    idx = np.zeros((b, kmax), dtype=np.int32)
    val = np.zeros((b, kmax), dtype=np.float32)
    for u in range(b):
        s, e = indptr_np[u], indptr_np[u + 1]
        idx[u, : e - s] = cols_np[s:e]
        val[u, : e - s] = vals_np[s:e]
    Hk = Ht.at[jnp.asarray(idx)].get(
        mode="promise_in_bounds"
    ).astype(jnp.float32)  # (b, kmax, r)
    if h_scale is not None:
        Hk = Hk * h_scale
    v = jnp.asarray(val)  # zero on padding, so c−1 = 0 there
    cm1 = alpha * v
    Gb = G[None] + jnp.einsum("ukr,uks,uk->urs", Hk, Hk, cm1)
    rhs = jnp.einsum("ukr,uk->ur", Hk, (1.0 + alpha * v) * v)
    return Gb, rhs
