"""shard_map update rules and error metrics on the 2-D mesh.

Each iteration is ONE shard_map region: every device runs the single-device
chunked COO primitives (`nmftpu.sparse_ops.wt_v/v_ht/sddmm`) on its local
tile, and the only cross-device traffic is

    psum over 'items': V H^T partials (block_rows, r), H H^T (r, r),
                       H row-sums (r,)
    psum over 'users': W^T V partials (r, block_cols), W^T W (r, r),
                       W column-sums (r,)

— the MPI-FAUN 2-D communication pattern (comm volume O((n/pu + m/pi) r)
per iteration), realized as XLA collectives. W stays
replicated along 'items', H along 'users', so the while_loop carry keeps a
stable sharding across iterations with zero resharding.

Padding rows/cols of W/H are absorbing zeros under every rule (zero
numerators / zero right-hand sides), so they never influence the error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from nmftpu.config import Algorithm, NmfConfig, Objective
from nmftpu.linalg import dense as D
from nmftpu.parallel.mesh import AXIS_ITEMS, AXIS_USERS
from nmftpu.parallel.sharded_coo import ShardedCOO
from nmftpu.sparse_ops import DeviceCOO, sddmm, v_ht, wt_v

_TILE = P(AXIS_USERS, AXIS_ITEMS, None)
_W_SPEC = P(AXIS_USERS, None)
_H_SPEC = P(None, AXIS_ITEMS)
_REP = P()


def _local(scoo_meta, vals, rows, cols) -> DeviceCOO:
    """Assemble the block-local DeviceCOO inside the shard_map region."""
    return DeviceCOO(
        values=vals[0, 0], rows=rows[0, 0], cols=cols[0, 0],
        shape=(scoo_meta.block_rows, scoo_meta.block_cols),
        nnz=-1, chunk=scoo_meta.chunk,
    )


def _shmap(mesh, f, in_specs, out_specs):
    # check_vma=False: the chunked-scan primitives initialize their
    # accumulators with unvarying zeros, which the VMA checker rejects even
    # though the psum placement is correct; correctness is covered by the
    # dense-oracle parity tests (tests/test_parallel.py).
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


# ---------------------------------------------------------------------------
# Sharded half-step building blocks (run INSIDE shard_map)
# ---------------------------------------------------------------------------


def _upd_w_fro(local, W, H, eps):
    numer = lax.psum(v_ht(local, H), AXIS_ITEMS)          # (br, r)
    HHt = lax.psum(D.gram_rows(H), AXIS_ITEMS)                   # (r, r)
    return W * (numer / (W @ HHt + eps))


def _upd_h_fro(local, W, H, eps):
    numer = lax.psum(wt_v(local, W), AXIS_USERS)          # (r, bc)
    WtW = lax.psum(D.gram_cols(W), AXIS_USERS)
    return H * (numer / (WtW @ H + eps))


def _upd_w_kl(local, W, H, eps):
    ratio = local.with_values(local.values / (sddmm(local, W, H) + eps))
    numer = lax.psum(v_ht(ratio, H), AXIS_ITEMS)
    h_sum = lax.psum(jnp.sum(H, axis=1), AXIS_ITEMS)      # (r,)
    return W * (numer / jnp.maximum(h_sum, eps)[None, :])


def _upd_h_kl(local, W, H, eps):
    ratio = local.with_values(local.values / (sddmm(local, W, H) + eps))
    numer = lax.psum(wt_v(ratio, W), AXIS_USERS)
    w_sum = lax.psum(jnp.sum(W, axis=0), AXIS_USERS)
    return H * (numer / jnp.maximum(w_sum, eps)[:, None])


def _upd_w_beta(local, W, H, beta, eps):
    """Generalized beta-MU W half on the grid mesh: the numerator is
    the usual psum'd SpMM with SDDMM-powered values (nonzero only at
    the stored set); the dense-in-FLOPs denominator streams
    (W (H_local))^(beta-1) H_localᵀ panels per device, psum'd over the
    items axis. Padding rows/cols start at zero and the multiplicative
    form keeps them zero (driver padding contract), so they never
    contribute. Guards/gamma/stabilization are sklearn's (linalg.dense
    .mu_update_beta is the oracle)."""
    from nmftpu.linalg import dense as DL
    from nmftpu.sparse_ops import _beta_numer_values, beta_denom_w_blocked

    gamma = DL.beta_gamma(beta)
    ratio = _beta_numer_values(local, W, H, beta)
    numer = lax.psum(v_ht(ratio, H), AXIS_ITEMS)
    blk = max(1, min(2048, H.shape[1]))
    denom = lax.psum(beta_denom_w_blocked(W, H, beta, blk), AXIS_ITEMS)
    denom = jnp.where(denom == 0.0, DL.EPSILON, denom)
    d = numer / denom
    if gamma != 1.0:
        d = d ** gamma
    out = W * d
    if beta < 1.0:
        out = jnp.where(out < DL._STAB_EPS, 0.0, out)
    return out


def _upd_h_beta(local, W, H, beta, eps):
    from nmftpu.linalg import dense as DL
    from nmftpu.sparse_ops import _beta_numer_values, beta_denom_h_blocked

    gamma = DL.beta_gamma(beta)
    ratio = _beta_numer_values(local, W, H, beta)
    numer = lax.psum(wt_v(ratio, W), AXIS_USERS)
    blk = max(1, min(2048, W.shape[0]))
    denom = lax.psum(beta_denom_h_blocked(W, H, beta, blk), AXIS_USERS)
    denom = jnp.where(denom == 0.0, DL.EPSILON, denom)
    d = numer / denom
    if gamma != 1.0:
        d = d ** gamma
    out = H * d
    if beta < 1.0:
        out = jnp.where(out < DL._STAB_EPS, 0.0, out)
    return out


def _upd_w_fro_masked(local, W, H, eps):
    """Completion MU W half on the mesh: the dense Gram denominator is
    replaced by the SDDMM of WH over the LOCAL tile's stored set (tile
    padding holds v = 0, so it drops out of the mask for free), psum'd
    like the numerator — the same collective pattern as plain MU."""
    wh = local.with_values(
        jnp.where(local.values != 0, sddmm(local, W, H), 0.0)
    )
    numer = lax.psum(v_ht(local, H), AXIS_ITEMS)
    denom = lax.psum(v_ht(wh, H), AXIS_ITEMS)
    return W * (numer / (denom + eps))


def _upd_h_fro_masked(local, W, H, eps):
    wh = local.with_values(
        jnp.where(local.values != 0, sddmm(local, W, H), 0.0)
    )
    numer = lax.psum(wt_v(local, W), AXIS_USERS)
    denom = lax.psum(wt_v(wh, W), AXIS_USERS)
    return H * (numer / (denom + eps))


def _upd_w_kl_masked(local, W, H, eps):
    """Masked KL W half: ratio numerator as usual (v = 0 padding slots
    contribute nothing), denominator = observed row mass of H (0/1-mask
    SpMM) instead of the full H row-sums."""
    ratio = local.with_values(local.values / (sddmm(local, W, H) + eps))
    mask = local.with_values(
        (local.values != 0).astype(local.values.dtype)
    )
    numer = lax.psum(v_ht(ratio, H), AXIS_ITEMS)
    denom = lax.psum(v_ht(mask, H), AXIS_ITEMS)
    return W * (numer / (denom + eps))


def _upd_h_kl_masked(local, W, H, eps):
    ratio = local.with_values(local.values / (sddmm(local, W, H) + eps))
    mask = local.with_values(
        (local.values != 0).astype(local.values.dtype)
    )
    numer = lax.psum(wt_v(ratio, W), AXIS_USERS)
    denom = lax.psum(wt_v(mask, W), AXIS_USERS)
    return H * (numer / (denom + eps))


def _upd_w_als_masked(local, W, H, lam, eps, solve):
    """Sharded exact completion ALS W half: per-row OBSERVED-only Grams
    from the local tile (0/1 indicator weight — no shared base Gram,
    unobserved entries carry zero weight), psum'd over items; batched
    per-row solves (exact Cholesky or warm-started PCG per
    config.als_solver) + clamp. Per-device memory: (block_rows, r, r)
    f32."""
    from nmftpu.sparse_ops import _weighted_row_grams

    ind = lambda v: (v != 0)  # noqa: E731
    dG = lax.psum(
        _weighted_row_grams(local, H.T.astype(jnp.float32), 0.0,
                            W.shape[0], weight_fn=ind),
        AXIS_ITEMS,
    )
    rhs = lax.psum(v_ht(local, H), AXIS_ITEMS).astype(jnp.float32)
    out = solve(dG, rhs, lam, eps, W.astype(jnp.float32))
    return out.astype(W.dtype)


def _upd_h_als_masked(local, W, H, lam, eps, solve):
    from nmftpu.sparse_ops import _weighted_row_grams

    ind = lambda v: (v != 0)  # noqa: E731
    dG = lax.psum(
        _weighted_row_grams(local, W.astype(jnp.float32), 0.0,
                            H.shape[1], by_cols=True, weight_fn=ind),
        AXIS_USERS,
    )
    rhs = lax.psum(wt_v(local, W), AXIS_USERS).T.astype(jnp.float32)
    out = solve(dG, rhs, lam, eps, H.T.astype(jnp.float32))
    return out.T.astype(H.dtype)


def _upd_w_weighted(local, W, H, alpha, eps):
    cv = local.with_values(local.values * (1.0 + alpha * local.values))
    swh = local.with_values(local.values * sddmm(local, W, H))
    numer = lax.psum(v_ht(cv, H), AXIS_ITEMS)
    HHt = lax.psum(D.gram_rows(H), AXIS_ITEMS)
    alpha_part = lax.psum(v_ht(swh, H), AXIS_ITEMS)
    return W * (numer / (W @ HHt + alpha * alpha_part + eps))


def _upd_h_weighted(local, W, H, alpha, eps):
    cv = local.with_values(local.values * (1.0 + alpha * local.values))
    swh = local.with_values(local.values * sddmm(local, W, H))
    numer = lax.psum(wt_v(cv, W), AXIS_USERS)
    WtW = lax.psum(D.gram_cols(W), AXIS_USERS)
    alpha_part = lax.psum(wt_v(swh, W), AXIS_USERS)
    return H * (numer / (WtW @ H + alpha * alpha_part + eps))


def _upd_w_hals(local, W, H, l2, l1, eps):
    """Sharded HALS W sweep: psum the numerator/Gram like plain ALS,
    then run the shared cyclic column sweep shard-local (W rows are
    disjoint across the users axis)."""
    r = W.shape[1]
    XHt = lax.psum(v_ht(local, H), AXIS_ITEMS) - l1
    G = lax.psum(D.gram_rows(H), AXIS_ITEMS) + l2 * jnp.eye(r, dtype=W.dtype)
    return D.hals_half_sweep(XHt, G, W)


def _upd_h_hals(local, W, H, l2, l1, eps):
    r = W.shape[1]
    XtW = lax.psum(wt_v(local, W), AXIS_USERS).T - l1   # (bc, r)
    G = lax.psum(D.gram_cols(W), AXIS_USERS) + l2 * jnp.eye(r, dtype=W.dtype)
    return D.hals_half_sweep(XtW, G, H.T).T


def _upd_w_als_weighted(local, W, H, alpha, lam, eps, solve):
    """Sharded iALS W half-step: per-row weighted Grams from the LOCAL
    tile's nonzeros (sparse_ops._weighted_row_grams), psum'd over the
    items axis so every W shard sees its rows' full Σ αv h hᵀ; the base
    Gram and c⊙v right-hand sides follow the plain-ALS psum pattern.
    Per-row solves honor config.als_solver (exact Cholesky vs
    warm-started PCG, x0 = the incoming shard). Per-device memory:
    (block_rows, r, r) f32."""
    from nmftpu.sparse_ops import _weighted_row_grams

    G = lax.psum(D.gram_rows(H).astype(jnp.float32), AXIS_ITEMS)
    dG = lax.psum(
        _weighted_row_grams(local, H.T.astype(jnp.float32), alpha,
                            W.shape[0]),
        AXIS_ITEMS,
    )
    cv = local.with_values(local.values * (1.0 + alpha * local.values))
    rhs = lax.psum(v_ht(cv, H), AXIS_ITEMS).astype(jnp.float32)
    out = solve(G[None] + dG, rhs, lam, eps, W.astype(jnp.float32))
    return out.astype(W.dtype)


def _upd_h_als_weighted(local, W, H, alpha, lam, eps, solve):
    from nmftpu.sparse_ops import _weighted_row_grams

    G = lax.psum(D.gram_cols(W).astype(jnp.float32), AXIS_USERS)
    dG = lax.psum(
        _weighted_row_grams(local, W.astype(jnp.float32), alpha,
                            H.shape[1], by_cols=True),
        AXIS_USERS,
    )
    cv = local.with_values(local.values * (1.0 + alpha * local.values))
    rhs = lax.psum(wt_v(cv, W), AXIS_USERS).T.astype(jnp.float32)
    out = solve(G[None] + dG, rhs, lam, eps, H.T.astype(jnp.float32))
    return out.T.astype(H.dtype)


_solve_clamped = D.solve_clamped


def _upd_w_als(local, W, H, shift, off, eps):
    rhs = lax.psum(v_ht(local, H), AXIS_ITEMS).T          # (r, br)
    gram = lax.psum(D.gram_rows(H), AXIS_ITEMS)
    return _solve_clamped(gram, rhs, shift, off, eps).T


def _upd_h_als(local, W, H, shift, off, eps):
    rhs = lax.psum(wt_v(local, W), AXIS_USERS)            # (r, bc)
    gram = lax.psum(D.gram_cols(W), AXIS_USERS)
    return _solve_clamped(gram, rhs, shift, off, eps)


# ---------------------------------------------------------------------------
# Registry: (make_aux, update, effective_h) on the mesh
# ---------------------------------------------------------------------------


def build_sharded_update(config: NmfConfig, mesh, scoo_meta: ShardedCOO):
    """Sharded twin of nmftpu.algorithms/build_sparse_update. The returned
    update(scoo, aux, W, H) wraps one shard_map region per iteration."""
    eps = config.eps
    order = config.update_order
    alg = config.algorithm
    obj = config.objective

    def make_step(upd_w, upd_h):
        def step(vals, rows, cols, W, H):
            local = _local(scoo_meta, vals, rows, cols)
            if order == "WH":
                W = upd_w(local, W, H)
                H = upd_h(local, W, H)
            else:
                H = upd_h(local, W, H)
                W = upd_w(local, W, H)
            return W, H

        shmapped = _shmap(
            mesh, step,
            in_specs=(_TILE, _TILE, _TILE, _W_SPEC, _H_SPEC),
            out_specs=(_W_SPEC, _H_SPEC),
        )

        def update(scoo, aux, W, H):
            return shmapped(scoo.values, scoo.rows, scoo.cols, W, H)

        return update

    def ident_h(aux, H):
        return H

    if config.mask == "observed":
        # matrix completion on the grid mesh: config validation has
        # already restricted this to MU (fro/KL) and ALS (fro)
        if alg is Algorithm.MU:
            if obj is Objective.FROBENIUS:
                update = make_step(
                    lambda l, W, H: _upd_w_fro_masked(l, W, H, eps),
                    lambda l, W, H: _upd_h_fro_masked(l, W, H, eps),
                )
            else:
                update = make_step(
                    lambda l, W, H: _upd_w_kl_masked(l, W, H, eps),
                    lambda l, W, H: _upd_h_kl_masked(l, W, H, eps),
                )
        else:
            from nmftpu.sparse_ops import _row_solver

            lw, lh = config.lambda_w, config.lambda_h
            solve = _row_solver(config.als_solver, config.cg_steps)
            update = make_step(
                lambda l, W, H: _upd_w_als_masked(l, W, H, lw, eps,
                                                  solve),
                lambda l, W, H: _upd_h_als_masked(l, W, H, lh, eps,
                                                  solve),
            )
        return (lambda scoo: ()), update, ident_h

    if alg is Algorithm.MU:
        if obj is Objective.FROBENIUS and config.alpha_confidence > 0.0:
            a = config.alpha_confidence
            update = make_step(
                lambda l, W, H: _upd_w_weighted(l, W, H, a, eps),
                lambda l, W, H: _upd_h_weighted(l, W, H, a, eps),
            )
        elif obj is Objective.FROBENIUS:
            update = make_step(
                lambda l, W, H: _upd_w_fro(l, W, H, eps),
                lambda l, W, H: _upd_h_fro(l, W, H, eps),
            )
        elif obj is Objective.BETA:
            b_ = config.beta
            update = make_step(
                lambda l, W, H: _upd_w_beta(l, W, H, b_, eps),
                lambda l, W, H: _upd_h_beta(l, W, H, b_, eps),
            )
        else:
            assert obj is Objective.KL, obj
            update = make_step(
                lambda l, W, H: _upd_w_kl(l, W, H, eps),
                lambda l, W, H: _upd_h_kl(l, W, H, eps),
            )
        return (lambda scoo: ()), update, ident_h

    if alg is Algorithm.HALS:
        lw, lh = config.lambda_w, config.lambda_h
        l1w, l1h = config.l1_w, config.l1_h
        update = make_step(
            lambda l, W, H: _upd_w_hals(l, W, H, lw, l1w, eps),
            lambda l, W, H: _upd_h_hals(l, W, H, lh, l1h, eps),
        )
        return (lambda scoo: ()), update, ident_h

    if alg is Algorithm.ALS and config.alpha_confidence > 0.0:
        from nmftpu.sparse_ops import _row_solver

        a = config.alpha_confidence
        lw, lh = config.lambda_w, config.lambda_h
        solve = _row_solver(config.als_solver, config.cg_steps)
        update = make_step(
            lambda l, W, H: _upd_w_als_weighted(l, W, H, a, lw, eps,
                                                solve),
            lambda l, W, H: _upd_h_als_weighted(l, W, H, a, lh, eps,
                                                solve),
        )
        return (lambda scoo: ()), update, ident_h

    if alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        from nmftpu.sparse_ops import _als_family_shifts

        sw, sh, ow, oh = _als_family_shifts(config)
        update = make_step(
            lambda l, W, H: _upd_w_als(l, W, H, sw, ow, eps),
            lambda l, W, H: _upd_h_als(l, W, H, sh, oh, eps),
        )
        return (lambda scoo: ()), update, ident_h

    if alg is Algorithm.GDCLS:
        lt = config.lambda_tik
        update = make_step(
            lambda l, W, H: _upd_w_fro(l, W, H, eps),
            lambda l, W, H: _upd_h_als(l, W, H, lt, 0.0, eps),
        )
        return (lambda scoo: ()), update, ident_h

    if alg is Algorithm.NSNMF:
        theta = config.theta
        rank = config.rank
        if obj is Objective.FROBENIUS:

            def upd_w(l, W, H, S):
                SH = S @ H
                numer = lax.psum(v_ht(l, SH), AXIS_ITEMS)
                G = lax.psum(D.gram_rows(SH), AXIS_ITEMS)
                return W * (numer / (W @ G + eps))

            def upd_h(l, W, H, S):
                WS = W @ S
                numer = lax.psum(wt_v(l, WS), AXIS_USERS)
                G = lax.psum(D.gram_cols(WS), AXIS_USERS)
                return H * (numer / (G @ H + eps))

        else:

            def upd_w(l, W, H, S):
                SH = S @ H
                ratio = l.with_values(l.values / (sddmm(l, W, SH) + eps))
                numer = lax.psum(v_ht(ratio, SH), AXIS_ITEMS)
                s_sum = lax.psum(jnp.sum(SH, axis=1), AXIS_ITEMS)
                return W * (numer / jnp.maximum(s_sum, eps)[None, :])

            def upd_h(l, W, H, S):
                WS = W @ S
                ratio = l.with_values(l.values / (sddmm(l, WS, H) + eps))
                numer = lax.psum(wt_v(ratio, WS), AXIS_USERS)
                s_sum = lax.psum(jnp.sum(WS, axis=0), AXIS_USERS)
                return H * (numer / jnp.maximum(s_sum, eps)[:, None])

        def step(vals, rows, cols, W, H, S):
            local = _local(scoo_meta, vals, rows, cols)
            if order == "WH":
                W = upd_w(local, W, H, S)
                H = upd_h(local, W, H, S)
            else:
                H = upd_h(local, W, H, S)
                W = upd_w(local, W, H, S)
            return W, H

        shmapped = _shmap(
            mesh, step,
            in_specs=(_TILE, _TILE, _TILE, _W_SPEC, _H_SPEC, _REP),
            out_specs=(_W_SPEC, _H_SPEC),
        )

        def update(scoo, aux, W, H):
            return shmapped(scoo.values, scoo.rows, scoo.cols, W, H, aux[0])

        def make_aux(scoo):
            return (
                D.nsnmf_smoothing_matrix(
                    rank, theta, dtype=scoo.values.dtype
                ),
            )

        def effective_h(aux, H):
            return aux[0] @ H

        return make_aux, update, effective_h

    raise ValueError(f"unknown algorithm: {alg}")


# ---------------------------------------------------------------------------
# Sharded error metrics (replicated scalars out)
# ---------------------------------------------------------------------------


def build_sharded_errors(mesh, scoo_meta: ShardedCOO, masked=False):
    """Returns (frobenius(scoo, W, He, svsq), kl(scoo, W, He)) — each one
    shard_map region producing a replicated scalar. With masked=True the
    metrics run over the OBSERVED set only (completion semantics; tile
    padding holds v = 0, which the mask drops)."""
    if masked:

        def fro_m(vals, rows, cols, W, H, svsq):
            local = _local(scoo_meta, vals, rows, cols)
            v = local.values
            resid = jnp.where(v != 0, v - sddmm(local, W, H), 0.0)
            total = lax.psum(
                lax.psum(jnp.sum(resid * resid), AXIS_USERS), AXIS_ITEMS
            )
            return jnp.sqrt(total)

        fro_m_sh = _shmap(
            mesh, fro_m,
            in_specs=(_TILE, _TILE, _TILE, _W_SPEC, _H_SPEC, _REP),
            out_specs=_REP,
        )

        def kl_m(vals, rows, cols, W, H):
            local = _local(scoo_meta, vals, rows, cols)
            v = local.values
            wh = jnp.maximum(sddmm(local, W, H), 1e-12)
            term = v * jnp.log(jnp.maximum(v, 1e-12) / wh) - v + wh
            local_sum = jnp.sum(jnp.where(v != 0, term, 0.0))
            return lax.psum(lax.psum(local_sum, AXIS_USERS), AXIS_ITEMS)

        kl_m_sh = _shmap(
            mesh, kl_m,
            in_specs=(_TILE, _TILE, _TILE, _W_SPEC, _H_SPEC),
            out_specs=_REP,
        )

        def frobenius_m(scoo, W, He, svsq):
            return fro_m_sh(
                scoo.values, scoo.rows, scoo.cols, W, He,
                jnp.reshape(svsq, (1,)),
            )

        def kl_err_m(scoo, W, He):
            return kl_m_sh(scoo.values, scoo.rows, scoo.cols, W, He)

        return frobenius_m, kl_err_m

    def fro(vals, rows, cols, W, H, svsq):
        local = _local(scoo_meta, vals, rows, cols)
        WtV = lax.psum(wt_v(local, W), AXIS_USERS)        # (r, bc)
        cross = lax.psum(jnp.sum(WtV * H), AXIS_ITEMS)
        WtW = lax.psum(D.gram_cols(W), AXIS_USERS)
        HHt = lax.psum(D.gram_rows(H), AXIS_ITEMS)
        quad = jnp.sum(WtW * HHt)
        return jnp.sqrt(jnp.maximum(svsq[0] - 2.0 * cross + quad, 0.0))

    fro_sh = _shmap(
        mesh, fro,
        in_specs=(_TILE, _TILE, _TILE, _W_SPEC, _H_SPEC, _REP),
        out_specs=_REP,
    )

    def kl(vals, rows, cols, W, H):
        local = _local(scoo_meta, vals, rows, cols)
        wh_nz = sddmm(local, W, H)
        v = local.values
        log_term = jnp.where(
            v > 0,
            v * jnp.log(jnp.maximum(v, 1e-12)
                        / jnp.maximum(wh_nz, 1e-12)),
            0.0,
        )
        local_sum = jnp.sum(log_term) - jnp.sum(v)
        total = lax.psum(lax.psum(local_sum, AXIS_USERS), AXIS_ITEMS)
        w_col = lax.psum(jnp.sum(W, axis=0), AXIS_USERS)
        h_row = lax.psum(jnp.sum(H, axis=1), AXIS_ITEMS)
        return total + w_col @ h_row

    kl_sh = _shmap(
        mesh, kl,
        in_specs=(_TILE, _TILE, _TILE, _W_SPEC, _H_SPEC),
        out_specs=_REP,
    )

    def frobenius(scoo, W, He, svsq):
        return fro_sh(
            scoo.values, scoo.rows, scoo.cols, W, He,
            jnp.reshape(svsq, (1,)),
        )

    def kl_err(scoo, W, He):
        return kl_sh(scoo.values, scoo.rows, scoo.cols, W, He)

    return frobenius, kl_err


def sum_wh_beta_tile(W, H, beta, n, m, br, bc):
    """Per-tile sum of (W H_local)^beta over the VALID region of this
    device's tile, streamed through (br, blk) panels; pad rows/cols are
    masked explicitly (a padded zero would be +inf at beta < 0; real WH
    zeros inf exactly as sklearn). Must run inside shard_map on the
    ('users','items') grid — the tile offset comes from axis_index.
    Shared by the scatter and ELL sharded beta errors."""
    ti = lax.axis_index(AXIS_USERS)
    tj = lax.axis_index(AXIS_ITEMS)
    row_valid = (ti * br + jnp.arange(br)) < n        # (br,)
    blk = max(1, min(2048, bc))
    nb = -(-bc // blk)
    Hp = jnp.pad(H, ((0, 0), (0, nb * blk - bc)))
    Hb = Hp.reshape(H.shape[0], nb, blk).transpose(1, 0, 2)
    col = jnp.arange(blk)

    def body(carry, x):
        i, Hblk = x
        WH = (W @ Hblk).astype(jnp.float32)
        gcol = tj * bc + i * blk + col
        valid = row_valid[:, None] & (
            ((i * blk + col) < bc) & (gcol < m)
        )[None, :]
        term = jnp.where(valid, WH ** beta, 0.0)
        return carry + jnp.sum(term), None

    acc, _ = lax.scan(
        body, jnp.asarray(0.0, jnp.float32),
        (jnp.arange(nb), Hb),
    )
    return acc


def build_sharded_beta_error(mesh, scoo_meta: ShardedCOO, beta: float):
    """D_beta(V || WH) on the grid mesh, sklearn's sparse-X semantics
    (twin of sparse_ops.beta_divergence_sparse): stored-set terms from
    the local tiles, the zero-position term sum (WH)^beta from per-tile
    (W H_local)^beta panels with pad rows/cols masked (see
    sum_wh_beta_tile)."""
    from nmftpu.linalg import dense as DL

    n, m = scoo_meta.shape
    br, bc = scoo_meta.block_rows, scoo_meta.block_cols

    def _sum_wh_beta_local(W, H):
        return sum_wh_beta_tile(W, H, beta, n, m, br, bc)

    def beta_err(vals, rows, cols, W, H):
        local = _local(scoo_meta, vals, rows, cols)
        v = local.values
        wh = sddmm(local, W, H)
        keep = v > DL.EPSILON
        wh_c = jnp.maximum(wh, DL.EPSILON)
        if beta == 0.0:
            div = (v / wh_c).astype(jnp.float32)
            s_div = jnp.sum(jnp.where(keep, div, 0.0))
            s_log = jnp.sum(jnp.where(
                keep, jnp.log(jnp.where(keep, div, 1.0)), 0.0))
            total = lax.psum(
                lax.psum(s_div - s_log, AXIS_USERS), AXIS_ITEMS
            )
            return total - float(n) * float(m)
        s_xb = jnp.sum(jnp.where(keep, (v ** beta).astype(jnp.float32),
                                 0.0))
        s_xwh = jnp.sum(jnp.where(
            keep, (v * wh_c ** (beta - 1.0)).astype(jnp.float32), 0.0))
        local_sum = (s_xb - beta * s_xwh
                     + (beta - 1.0) * _sum_wh_beta_local(W, H))
        total = lax.psum(lax.psum(local_sum, AXIS_USERS), AXIS_ITEMS)
        return total / (beta * (beta - 1.0))

    beta_sh = _shmap(
        mesh, beta_err,
        in_specs=(_TILE, _TILE, _TILE, _W_SPEC, _H_SPEC),
        out_specs=_REP,
    )

    def err(scoo, W, He):
        return beta_sh(scoo.values, scoo.rows, scoo.cols, W, He)

    return err
