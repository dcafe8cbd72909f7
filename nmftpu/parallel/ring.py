"""Ring-SpMM updates on a 1-D mesh (SURVEY.md §2.9 SP/ring analog, §5.7).

The 2-D grid engine (parallel/updates.py) is the default; this module is
the ring-topology alternative for 1-D meshes / very long item axes —
structurally the ring-attention pattern with H blocks in the KV role:

* p devices; device i owns W row-block i, H column-block i, and its row
  panel of V pre-split into p column tiles (block-local indices).
* W-side numerators (V·Hᵀ and friends): H blocks ROTATE around the ring
  (`lax.ppermute`); at step s device i holds H block (i−s) mod p and
  consumes its matching V tile — after p use-and-rotate steps every W
  shard has seen every H block and H is home again.
* H-side numerators:
  - Frobenius/ALS need only WᵀV: a ring REDUCE — per-block accumulators
    travel the ring, each device adding its contribution for the block
    the accumulator is destined to; a final +2 rotation delivers every
    completed block to its owner.
  - KL/weighted need the resident H block too (the SDDMM ratio), so the
    (H block, accumulator) PAIR rotates together; after p−1 add-and-rotate
    steps plus one delivery rotation both are home.
* Grams (WᵀW, HHᵀ) and row/col sums are `psum`s, as in the grid engine.

Per-iteration comm volume: O(r·m) rotated around the ring (2·r·m for the
pair rotation) + r·n for the W side — higher than the 2-D grid's
O((n/pu + m/pi)·r); use the ring when the item axis alone must
scale.

Supported here: MU (Frobenius, KL, generalized beta, confidence-
weighted), ALS/ACLS/AHCLS, GDCLS, nsNMF (both objectives) — full parity
with the grid engine. Selected via `compute_sharded(..., engine="ring")`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nmftpu.config import Algorithm, NmfConfig, Objective
from nmftpu.linalg import dense as D
from nmftpu.parallel.sharded_coo import partition_sparse
from nmftpu.sparse_ops import DeviceCOO, sddmm, v_ht, wt_v
from nmftpu import sparse as host_sparse

AXIS_RING = "shards"


def make_ring_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS_RING,))


def ring_shardings(mesh: Mesh):
    return {
        "W": NamedSharding(mesh, P(AXIS_RING, None)),
        "H": NamedSharding(mesh, P(None, AXIS_RING)),
        "tiles": NamedSharding(mesh, P(AXIS_RING, None, None)),
        "replicated": NamedSharding(mesh, P()),
    }


def partition_for_ring(mat: host_sparse.SparseMatrix, p: int, **kw):
    """Device i gets its V row panel as p column tiles: reuse the 2-D
    partitioner with a (p, p) grid; only the leading axis is sharded."""
    return partition_sparse(mat, (p, p), **kw)


def _tile(scoo_meta, vals, rows, cols, j):
    """Block-local DeviceCOO for the traced column-tile index j."""
    return DeviceCOO(
        values=lax.dynamic_index_in_dim(vals, j, 0, keepdims=False),
        rows=lax.dynamic_index_in_dim(rows, j, 0, keepdims=False),
        cols=lax.dynamic_index_in_dim(cols, j, 0, keepdims=False),
        shape=(scoo_meta.block_rows, scoo_meta.block_cols),
        nnz=-1,
        chunk=scoo_meta.chunk,
    )


class _Ring:
    """The three ring dataflows, parameterized by per-tile contribution
    functions. Everything here runs INSIDE a shard_map region."""

    def __init__(self, scoo_meta, p):
        self.meta = scoo_meta
        self.p = p
        self.fwd = [(k, (k + 1) % p) for k in range(p)]

    def rotate_w(self, vals, rows, cols, H, contrib):
        """acc_i = Σ_j contrib(tile_ij, H_j) by rotating H. Returns
        (acc (bn, x), H home again)."""
        my = lax.axis_index(AXIS_RING)
        p = self.p

        def body(s, carry):
            H_rot, acc = carry
            j = (my - s) % p
            local = _tile(self.meta, vals, rows, cols, j)
            acc = acc + contrib(local, H_rot)
            H_rot = lax.ppermute(H_rot, AXIS_RING, self.fwd)
            return (H_rot, acc)

        # the probe only fixes the accumulator shape/dtype; XLA DCEs it
        probe = jax.eval_shape(
            lambda h: contrib(_tile(self.meta, vals, rows, cols, my), h), H
        )
        acc0 = jnp.zeros(probe.shape, probe.dtype)
        H_home, acc = lax.fori_loop(0, p, body, (H, acc0))
        return acc, H_home

    def rotate_w_sum(self, vals, rows, cols, H, contrib):
        """Scalar variant: acc = Σ_j contrib(tile_ij, H_j) (errors)."""
        my = lax.axis_index(AXIS_RING)
        p = self.p

        def body(s, carry):
            H_rot, acc = carry
            j = (my - s) % p
            local = _tile(self.meta, vals, rows, cols, j)
            acc = acc + contrib(local, H_rot)
            H_rot = lax.ppermute(H_rot, AXIS_RING, self.fwd)
            return (H_rot, acc)

        _, acc = lax.fori_loop(
            0, p, body, (H, jnp.asarray(0.0, jnp.float32))
        )
        return acc

    def reduce_h(self, vals, rows, cols, contrib):
        """Ring reduce for H-side numerators NOT needing the H block:
        accumulator destined for block b visits every device once.
        contrib(tile_ib) -> (r, bm)."""
        my = lax.axis_index(AXIS_RING)
        p = self.p

        acc = contrib(_tile(self.meta, vals, rows, cols, (my + 1) % p))

        def body(s, acc):
            acc = lax.ppermute(acc, AXIS_RING, self.fwd)
            b = (my - s + 1) % p
            return acc + contrib(_tile(self.meta, vals, rows, cols, b))

        acc = lax.fori_loop(1, p, body, acc)
        # after the loop the accumulator destined for block (my+2) sits at
        # device my, for every p: deliver with a +2 rotation.
        if p > 2:
            home = [(k, (k + 2) % p) for k in range(p)]
            acc = lax.ppermute(acc, AXIS_RING, home)
        return acc

    def pair_reduce_h(self, vals, rows, cols, H, contrib):
        """Ring reduce where the contribution needs the destination H
        block (KL ratio, weighted SDDMM): the (H block, accumulator) pair
        rotates together. contrib(tile_ij, H_j) -> (r, bm). Returns the
        completed accumulator, home at its owner."""
        my = lax.axis_index(AXIS_RING)
        p = self.p

        acc = contrib(_tile(self.meta, vals, rows, cols, my), H)

        def body(s, carry):
            H_rot, acc = carry
            H_rot = lax.ppermute(H_rot, AXIS_RING, self.fwd)
            acc = lax.ppermute(acc, AXIS_RING, self.fwd)
            j = (my - s) % p
            acc = acc + contrib(
                _tile(self.meta, vals, rows, cols, j), H_rot
            )
            return (H_rot, acc)

        H_rot, acc = lax.fori_loop(1, p, body, (H, acc))
        # destined block (my+1) sits at device my: one delivery rotation
        return lax.ppermute(acc, AXIS_RING, self.fwd)


_solve_clamped = D.solve_clamped


def build_ring_update(config: NmfConfig, mesh: Mesh, scoo_meta):
    """Ring twin of parallel.updates.build_sharded_update: returns
    (make_aux, update, effective_h); update(scoo, aux, W, H) is ONE
    shard_map region per iteration."""
    eps = config.eps
    order = config.update_order
    alg = config.algorithm
    obj = config.objective
    p = mesh.devices.size
    ring = _Ring(scoo_meta, p)

    # ---- W half-steps (rotation) -------------------------------------
    def w_fro(vals, rows, cols, W, H, HT=None):
        # HT: optional transform of each rotated H block (nsNMF's S@H)
        tf = HT if HT is not None else (lambda h: h)
        numer, _ = ring.rotate_w(
            vals, rows, cols, H, lambda l, h: v_ht(l, tf(h))
        )
        Ht = tf(H)
        G = lax.psum(D.gram_rows(Ht), AXIS_RING)
        return W * (numer / (W @ G + eps))

    def w_kl(vals, rows, cols, W, H, HT=None):
        tf = HT if HT is not None else (lambda h: h)

        def contrib(l, h):
            ht = tf(h)
            ratio = l.with_values(l.values / (sddmm(l, W, ht) + eps))
            return v_ht(ratio, ht)

        numer, _ = ring.rotate_w(vals, rows, cols, H, contrib)
        s_sum = lax.psum(jnp.sum(tf(H), axis=1), AXIS_RING)
        return W * (numer / jnp.maximum(s_sum, eps)[None, :])

    def w_beta(vals, rows, cols, W, H, beta):
        """Generalized beta-MU W half on the ring: ONE rotation carries
        both the powered-SDDMM numerator (nonzero only at the stored
        set) and the dense denominator's per-block panels
        (W h)^(beta-1) hᵀ, streamed through column sub-panels
        (sparse_ops.beta_denom_w_blocked) so no (bn, bc) tile-dense
        intermediate materializes. Guards/gamma/stabilization are
        sklearn's."""
        from nmftpu.sparse_ops import (_beta_numer_values,
                                       beta_denom_w_blocked)

        gamma = D.beta_gamma(beta)
        r = W.shape[1]
        blk = max(1, min(2048, H.shape[1]))

        def contrib(l, h):
            ratio = _beta_numer_values(l, W, h, beta)
            return jnp.concatenate(
                [v_ht(ratio, h),
                 beta_denom_w_blocked(W, h, beta, blk)], axis=1)

        both, _ = ring.rotate_w(vals, rows, cols, H, contrib)
        numer, denom = both[:, :r], both[:, r:]
        denom = jnp.where(denom == 0.0, D.EPSILON, denom)
        d = numer / denom
        if gamma != 1.0:
            d = d ** gamma
        out = W * d
        if beta < 1.0:
            out = jnp.where(out < D._STAB_EPS, 0.0, out)
        return out

    def w_weighted(vals, rows, cols, W, H, alpha):
        def contrib(l, h):
            cv = l.with_values(l.values * (1.0 + alpha * l.values))
            swh = l.with_values(l.values * sddmm(l, W, h))
            return jnp.concatenate(
                [v_ht(cv, h), v_ht(swh, h)], axis=1
            )

        both, _ = ring.rotate_w(vals, rows, cols, H, contrib)
        r = W.shape[1]
        numer, alpha_part = both[:, :r], both[:, r:]
        HHt = lax.psum(D.gram_rows(H), AXIS_RING)
        return W * (numer / (W @ HHt + alpha * alpha_part + eps))

    def w_als(vals, rows, cols, W, H, shift, off):
        rhs, _ = ring.rotate_w(vals, rows, cols, H, v_ht)
        gram = lax.psum(D.gram_rows(H), AXIS_RING)
        return _solve_clamped(gram, rhs.T, shift, off, eps).T

    def w_hals(vals, rows, cols, W, H, l2, l1):
        r = W.shape[1]
        XHt, _ = ring.rotate_w(vals, rows, cols, H, v_ht)
        G = lax.psum(D.gram_rows(H), AXIS_RING) + l2 * jnp.eye(r, dtype=W.dtype)
        return D.hals_half_sweep(XHt - l1, G, W)

    def w_als_weighted(vals, rows, cols, W, H, alpha, lam):
        """Ring iALS W half: ONE rotation carries both the per-row
        weighted Gram deltas and the c⊙v right-hand sides (flattened
        into a single (bn, r² + r) accumulator — rotate_w's carry is
        shape-agnostic); the base Gram is a psum."""
        from nmftpu.sparse_ops import _weighted_row_grams

        bn, r = W.shape

        def contrib(l, h):
            dg = _weighted_row_grams(
                l, h.T.astype(jnp.float32), alpha, bn
            ).reshape(bn, r * r)
            cv = l.with_values(l.values * (1.0 + alpha * l.values))
            return jnp.concatenate(
                [dg, v_ht(cv, h).astype(jnp.float32)], axis=1
            )

        both, _ = ring.rotate_w(vals, rows, cols, H, contrib)
        dG = both[:, : r * r].reshape(bn, r, r)
        rhs = both[:, r * r:]
        G = lax.psum(D.gram_rows(H).astype(jnp.float32), AXIS_RING)
        out = D._batched_solve_clamped(G[None] + dG, rhs, lam, eps)
        return out.astype(W.dtype)

    # ---- H half-steps (ring reduce) ----------------------------------
    def h_fro(vals, rows, cols, W, H, WT=None):
        Wt = WT(W) if WT is not None else W
        numer = ring.reduce_h(vals, rows, cols, lambda l: wt_v(l, Wt))
        G = lax.psum(D.gram_cols(Wt), AXIS_RING)
        return H * (numer / (G @ H + eps))

    def h_kl(vals, rows, cols, W, H, WT=None):
        Wt = WT(W) if WT is not None else W

        def contrib(l, h):
            ratio = l.with_values(l.values / (sddmm(l, Wt, h) + eps))
            return wt_v(ratio, Wt)

        numer = ring.pair_reduce_h(vals, rows, cols, H, contrib)
        s_sum = lax.psum(jnp.sum(Wt, axis=0), AXIS_RING)
        return H * (numer / jnp.maximum(s_sum, eps)[:, None])

    def h_beta(vals, rows, cols, W, H, beta):
        from nmftpu.sparse_ops import (_beta_numer_values,
                                       beta_denom_h_blocked)

        gamma = D.beta_gamma(beta)
        r = W.shape[1]
        blk = max(1, min(2048, W.shape[0]))

        def contrib(l, h):
            ratio = _beta_numer_values(l, W, h, beta)
            return jnp.concatenate(
                [wt_v(ratio, W),
                 beta_denom_h_blocked(W, h, beta, blk)], axis=0)

        both = ring.pair_reduce_h(vals, rows, cols, H, contrib)
        numer, denom = both[:r], both[r:]
        denom = jnp.where(denom == 0.0, D.EPSILON, denom)
        d = numer / denom
        if gamma != 1.0:
            d = d ** gamma
        out = H * d
        if beta < 1.0:
            out = jnp.where(out < D._STAB_EPS, 0.0, out)
        return out

    def h_weighted(vals, rows, cols, W, H, alpha):
        def contrib(l, h):
            cv = l.with_values(l.values * (1.0 + alpha * l.values))
            swh = l.with_values(l.values * sddmm(l, W, h))
            return jnp.concatenate(
                [wt_v(cv, W), wt_v(swh, W)], axis=0
            )

        both = ring.pair_reduce_h(vals, rows, cols, H, contrib)
        r = W.shape[1]
        numer, alpha_part = both[:r], both[r:]
        WtW = lax.psum(D.gram_cols(W), AXIS_RING)
        return H * (numer / (WtW @ H + alpha * alpha_part + eps))

    def h_als(vals, rows, cols, W, H, shift, off):
        rhs = ring.reduce_h(vals, rows, cols, lambda l: wt_v(l, W))
        gram = lax.psum(D.gram_cols(W), AXIS_RING)
        return _solve_clamped(gram, rhs, shift, off, eps)

    def h_hals(vals, rows, cols, W, H, l2, l1):
        r = W.shape[1]
        XtW = ring.reduce_h(vals, rows, cols, lambda l: wt_v(l, W)).T
        G = lax.psum(D.gram_cols(W), AXIS_RING) + l2 * jnp.eye(r, dtype=W.dtype)
        return D.hals_half_sweep(XtW - l1, G, H.T).T

    def h_als_weighted(vals, rows, cols, W, H, alpha, lam):
        """Ring iALS H half: per-column Gram deltas need only the
        RESIDENT W block per contribution, so ONE ring reduce carries
        the flattened (bm, r² + r) deltas+rhs accumulator."""
        from nmftpu.sparse_ops import _weighted_row_grams

        r, bm = H.shape
        W32 = W.astype(jnp.float32)

        def contrib(l):
            dg = _weighted_row_grams(
                l, W32, alpha, bm, by_cols=True
            ).reshape(bm, r * r)
            cv = l.with_values(l.values * (1.0 + alpha * l.values))
            return jnp.concatenate(
                [dg, wt_v(cv, W).T.astype(jnp.float32)], axis=1
            )

        both = ring.reduce_h(vals, rows, cols, contrib)
        dG = both[:, : r * r].reshape(bm, r, r)
        rhs = both[:, r * r:]
        G = lax.psum(D.gram_cols(W).astype(jnp.float32), AXIS_RING)
        out = D._batched_solve_clamped(G[None] + dG, rhs, lam, eps)
        return out.T.astype(H.dtype)

    # ---- assemble ----------------------------------------------------
    def make_step(upd_w, upd_h, with_s=False):
        def step(vals, rows, cols, W, H, *s):
            vals, rows, cols = vals[0], rows[0], cols[0]
            args = s if with_s else ()
            if order == "WH":
                W = upd_w(vals, rows, cols, W, H, *args)
                H = upd_h(vals, rows, cols, W, H, *args)
            else:
                H = upd_h(vals, rows, cols, W, H, *args)
                W = upd_w(vals, rows, cols, W, H, *args)
            return W, H

        tiles = P(AXIS_RING, None, None)
        in_specs = (tiles, tiles, tiles, P(AXIS_RING, None),
                    P(None, AXIS_RING))
        if with_s:
            in_specs = in_specs + (P(),)
        shmapped = jax.shard_map(
            step, mesh=mesh, in_specs=in_specs,
            out_specs=(P(AXIS_RING, None), P(None, AXIS_RING)),
            check_vma=False,
        )

        def update(scoo, aux, W, H):
            extra = aux if with_s else ()
            return shmapped(scoo.values, scoo.rows, scoo.cols, W, H,
                            *extra)

        return update

    ident_h = lambda aux, H: H  # noqa: E731
    no_aux = lambda scoo: ()  # noqa: E731

    if alg is Algorithm.MU:
        if obj is Objective.FROBENIUS and config.alpha_confidence > 0.0:
            a = config.alpha_confidence
            update = make_step(
                lambda v, r_, c, W, H: w_weighted(v, r_, c, W, H, a),
                lambda v, r_, c, W, H: h_weighted(v, r_, c, W, H, a),
            )
        elif obj is Objective.FROBENIUS:
            update = make_step(w_fro, h_fro)
        elif obj is Objective.BETA:
            b_ = config.beta
            update = make_step(
                lambda v, r_, c, W, H: w_beta(v, r_, c, W, H, b_),
                lambda v, r_, c, W, H: h_beta(v, r_, c, W, H, b_),
            )
        else:
            assert obj is Objective.KL, obj
            update = make_step(w_kl, h_kl)
        return no_aux, update, ident_h

    if alg is Algorithm.HALS:
        lw, lh = config.lambda_w, config.lambda_h
        l1w, l1h = config.l1_w, config.l1_h
        update = make_step(
            lambda v, r_, c, W, H: w_hals(v, r_, c, W, H, lw, l1w),
            lambda v, r_, c, W, H: h_hals(v, r_, c, W, H, lh, l1h),
        )
        return no_aux, update, ident_h

    if alg is Algorithm.ALS and config.alpha_confidence > 0.0:
        a = config.alpha_confidence
        lw, lh = config.lambda_w, config.lambda_h
        update = make_step(
            lambda v, r_, c, W, H: w_als_weighted(v, r_, c, W, H, a, lw),
            lambda v, r_, c, W, H: h_als_weighted(v, r_, c, W, H, a, lh),
        )
        return no_aux, update, ident_h

    if alg in (Algorithm.ALS, Algorithm.ACLS, Algorithm.AHCLS):
        from nmftpu.sparse_ops import _als_family_shifts

        sw, sh, ow, oh = _als_family_shifts(config)
        update = make_step(
            lambda v, r_, c, W, H: w_als(v, r_, c, W, H, sw, ow),
            lambda v, r_, c, W, H: h_als(v, r_, c, W, H, sh, oh),
        )
        return no_aux, update, ident_h

    if alg is Algorithm.GDCLS:
        lt = config.lambda_tik
        update = make_step(
            w_fro,
            lambda v, r_, c, W, H: h_als(v, r_, c, W, H, lt, 0.0),
        )
        return no_aux, update, ident_h

    if alg is Algorithm.NSNMF:
        theta = config.theta
        rank = config.rank

        if obj is Objective.FROBENIUS:
            update = make_step(
                lambda v, r_, c, W, H, S: w_fro(
                    v, r_, c, W, H, HT=lambda h: S @ h
                ),
                lambda v, r_, c, W, H, S: h_fro(
                    v, r_, c, W, H, WT=lambda w: w @ S
                ),
                with_s=True,
            )
        else:
            update = make_step(
                lambda v, r_, c, W, H, S: w_kl(
                    v, r_, c, W, H, HT=lambda h: S @ h
                ),
                lambda v, r_, c, W, H, S: h_kl(
                    v, r_, c, W, H, WT=lambda w: w @ S
                ),
                with_s=True,
            )

        def make_aux(scoo):
            return (
                D.nsnmf_smoothing_matrix(
                    rank, theta, dtype=scoo.values.dtype
                ),
            )

        return make_aux, update, lambda aux, H: aux[0] @ H

    raise ValueError(f"ring engine does not support algorithm {alg}")


def build_ring_errors(mesh: Mesh, scoo_meta):
    """(frobenius(scoo, W, He, svsq), kl(scoo, W, He)) on the ring: the
    nonzero-sampled terms accumulate over one H rotation; Grams/sums are
    psums. Each returns a replicated scalar."""
    p = mesh.devices.size
    ring = _Ring(scoo_meta, p)
    tiles = P(AXIS_RING, None, None)

    def fro(vals, rows, cols, W, H, svsq):
        vals, rows, cols = vals[0], rows[0], cols[0]
        cross = lax.psum(
            ring.rotate_w_sum(
                vals, rows, cols, H,
                lambda l, h: jnp.sum(l.values * sddmm(l, W, h)),
            ),
            AXIS_RING,
        )
        WtW = lax.psum(D.gram_cols(W), AXIS_RING)
        HHt = lax.psum(D.gram_rows(H), AXIS_RING)
        quad = jnp.sum(WtW * HHt)
        return jnp.sqrt(jnp.maximum(svsq[0] - 2.0 * cross + quad, 0.0))

    fro_sh = jax.shard_map(
        fro, mesh=mesh,
        in_specs=(tiles, tiles, tiles, P(AXIS_RING, None),
                  P(None, AXIS_RING), P()),
        out_specs=P(),
        check_vma=False,
    )

    def kl(vals, rows, cols, W, H):
        vals, rows, cols = vals[0], rows[0], cols[0]

        def log_terms(l, h):
            wh = sddmm(l, W, h)
            v = l.values
            t = jnp.where(
                v > 0,
                v * jnp.log(jnp.maximum(v, 1e-12)
                            / jnp.maximum(wh, 1e-12)),
                0.0,
            )
            return jnp.sum(t) - jnp.sum(v)

        total = lax.psum(
            ring.rotate_w_sum(vals, rows, cols, H, log_terms), AXIS_RING
        )
        w_col = lax.psum(jnp.sum(W, axis=0), AXIS_RING)
        h_row = lax.psum(jnp.sum(H, axis=1), AXIS_RING)
        return total + w_col @ h_row

    kl_sh = jax.shard_map(
        kl, mesh=mesh,
        in_specs=(tiles, tiles, tiles, P(AXIS_RING, None),
                  P(None, AXIS_RING)),
        out_specs=P(),
        check_vma=False,
    )

    def frobenius(scoo, W, He, svsq):
        return fro_sh(scoo.values, scoo.rows, scoo.cols, W, He,
                      jnp.reshape(svsq, (1,)))

    def kl_err(scoo, W, He):
        return kl_sh(scoo.values, scoo.rows, scoo.cols, W, He)

    return frobenius, kl_err


def build_ring_data_init(config: NmfConfig, mesh: Mesh, scoo_meta):
    """Ring-native data-dependent init (MeanColumns / k-means family):
    the same Lloyd math as parallel.init_sharded (SURVEY.md §3.4) but
    expressed with the ring dataflows — centroid row-blocks stay
    resident per device, per-column quantities (col norms, cross terms,
    WᵀV) ring-REDUCE to their block owner, and the one-hot assignment
    blocks ROTATE for the centroid update. No single-device detour, no
    full factor on any device (closes STATUS round-2 gap 4).

    Returns init(key, scoo) -> (W P(ring, None), H P(None, ring))."""
    from nmftpu.config import Initialization
    from nmftpu.sparse_ops import (
        col_sums,
        extract_columns,
        project_columns,
    )

    method = config.init_method
    rank = config.rank
    max_iter = config.kmeans_max_iter
    n, m = scoo_meta.shape
    bm = scoo_meta.block_cols
    p = mesh.devices.size
    ring = _Ring(scoo_meta, p)

    def f(key, vals, rows, cols):
        vals, rows, cols = vals[0], rows[0], cols[0]
        dtype = vals.dtype
        my = lax.axis_index(AXIS_RING)
        kw, kh, kk = jax.random.split(key, 3)
        del kw  # W is data-dependent in every strategy handled here

        mean_v = lax.psum(jnp.sum(vals), AXIS_RING) / (
            float(n) * float(m)
        )
        scale = jnp.sqrt(jnp.maximum(mean_v, 1e-12) / rank).astype(dtype)

        def rand_h():
            # shard-local randomness, folded by the ring index (identical
            # convention to the grid init's items-axis fold)
            k_loc = jax.random.fold_in(kh, my)
            u = jax.random.uniform(k_loc, (rank, bm), dtype=dtype)
            return (u + jnp.asarray(1e-4, dtype)) * scale

        def sum_tiles(contrib):
            """acc = Σ_j contrib(tile_ij, j) over the p RESIDENT column
            tiles of this device's row panel — no communication (row
            blocks are disjoint across the ring)."""
            def body(j, acc):
                return acc + contrib(
                    _tile(scoo_meta, vals, rows, cols, j), j
                )

            acc0 = contrib(_tile(scoo_meta, vals, rows, cols, 0), 0)
            return lax.fori_loop(1, p, body, acc0)

        if method is Initialization.MEAN_COLUMNS:
            q = int(min(max(5, m // max(rank, 1)), m))
            cols_s = jax.random.randint(kk, (rank, q), 0, m)
            flat = cols_s.reshape(-1)
            rep = jnp.repeat(jnp.arange(rank), q)

            def mc_contrib(local, j):
                # A_loc[c_local, k] = (#times local col c sampled for k)/q.
                # Samples in earlier column blocks give negative local ids,
                # which JAX wraps NumPy-style BEFORE mode="drop" — remap to
                # bm (positive out-of-bounds) so they are genuinely dropped.
                loc = flat - j * bm
                loc = jnp.where(loc < 0, bm, loc)
                A = jnp.zeros((bm, rank), dtype).at[
                    loc, rep
                ].add(1.0 / q, mode="drop")
                return project_columns(local, A)

            return sum_tiles(mc_contrib), rand_h()

        # --- k-means family (oracle: sparse_ops.kmeans_columns_sparse) --
        cols_s = jax.random.choice(kk, m, shape=(rank,), replace=False)
        centroids = sum_tiles(
            lambda local, j: extract_columns(local, cols_s - j * bm)
        )                                                   # (bn, r)

        # per-column ||v||^2 of this device's OWN block: ring reduce of
        # per-stripe partial column sums
        col_sq = ring.reduce_h(
            vals, rows, cols,
            lambda l: col_sums(l.with_values(l.values * l.values)),
        )                                                   # (bm,)
        col_ids = my * bm + jnp.arange(bm)
        valid = col_ids < m  # padded columns get pseudo-label `rank`

        def assign(C):
            cross = ring.reduce_h(
                vals, rows, cols, lambda l: wt_v(l, C)
            ).T                                             # (bm, r)
            cent_sq = lax.psum(jnp.sum(C * C, axis=0), AXIS_RING)
            d2 = col_sq[:, None] - 2.0 * cross + cent_sq[None, :]
            return jnp.where(valid, jnp.argmin(d2, axis=1), rank)

        def body(_, C):
            labels = assign(C)
            onehot = jax.nn.one_hot(labels, rank, dtype=dtype)  # (bm, r)
            sums, _ = ring.rotate_w(
                vals, rows, cols, onehot,
                lambda l, oh: project_columns(l, oh),
            )                                               # (bn, r)
            counts = lax.psum(jnp.sum(onehot, axis=0), AXIS_RING)
            new = sums / jnp.maximum(counts, 1.0)[None, :]
            return jnp.where(counts[None, :] > 0, new, C)

        centroids = lax.fori_loop(0, max_iter, body, centroids)
        W = jnp.maximum(centroids, 0.0) + jnp.asarray(1e-6, dtype)

        if method is Initialization.K_MEANS_AND_RANDOM_VALUES:
            H = rand_h()
        else:
            WtV = ring.reduce_h(
                vals, rows, cols, lambda l: wt_v(l, W)
            )                                               # (r, bm)
            if method is Initialization.K_MEANS_AND_NON_NEGATIVE_WTV:
                H = jnp.maximum(WtV, 0.0) + jnp.asarray(1e-6, dtype)
            else:
                H = jnp.abs(WtV) + jnp.asarray(1e-6, dtype)
        return W, H

    tiles = P(AXIS_RING, None, None)
    shmapped = jax.jit(jax.shard_map(
        f, mesh=mesh,
        in_specs=(P(), tiles, tiles, tiles),
        out_specs=(P(AXIS_RING, None), P(None, AXIS_RING)),
        check_vma=False,
    ))

    def init(key, scoo):
        return shmapped(key, scoo.values, scoo.rows, scoo.cols)

    return init


def build_ring_mu_update(mesh: Mesh, scoo_meta, eps=1e-9, order="WH"):
    """Back-compat wrapper: plain MU-Frobenius update(scoo, W, H)."""
    cfg = NmfConfig(rank=1, num_iterations=1, eps=eps, update_order=order)
    _, update, _ = build_ring_update(cfg, mesh, scoo_meta)
    return lambda scoo, W, H: update(scoo, (), W, H)


def build_ring_beta_error(mesh: Mesh, scoo_meta, beta: float):
    """D_beta(V || WH) on the ring, sklearn's sparse-X semantics (twin
    of parallel.updates.build_sharded_beta_error): stored-set terms
    accumulate over one H rotation; the zero-position term sum (WH)^beta
    runs a second rotation with per-block (W h)^beta panel sums,
    streamed through column sub-panels with pad rows/cols masked."""
    from nmftpu.linalg import dense as DL

    p = mesh.devices.size
    ring = _Ring(scoo_meta, p)
    tiles = P(AXIS_RING, None, None)
    n, m = scoo_meta.shape
    bn, bc = scoo_meta.block_rows, scoo_meta.block_cols

    def _masked_sum_wh_beta(W, h, row_valid, col0):
        """sum over the valid entries of (W h)^beta, blocked over h's
        columns (no (bn, bc) panel materializes)."""
        blk = max(1, min(2048, bc))
        nb = -(-bc // blk)
        hp = jnp.pad(h, ((0, 0), (0, nb * blk - bc)))
        hb = hp.reshape(h.shape[0], nb, blk).transpose(1, 0, 2)
        col = jnp.arange(blk)

        def body(carry, x):
            i, hblk = x
            WH = (W @ hblk).astype(jnp.float32)
            valid = row_valid[:, None] & (
                ((i * blk + col) < bc) & ((col0 + i * blk + col) < m)
            )[None, :]
            return carry + jnp.sum(jnp.where(valid, WH ** beta, 0.0)), None

        acc, _ = lax.scan(body, jnp.asarray(0.0, jnp.float32),
                          (jnp.arange(nb), hb))
        return acc

    def err(vals, rows, cols, W, H):
        vals, rows, cols = vals[0], rows[0], cols[0]
        my = lax.axis_index(AXIS_RING)
        row_valid = (my * bn + jnp.arange(bn)) < n

        if beta == 0.0:
            def is_terms(l, h):
                wh = sddmm(l, W, h)
                v = l.values
                keep = v > DL.EPSILON
                div = (v / jnp.maximum(wh, DL.EPSILON)).astype(
                    jnp.float32)
                s_div = jnp.sum(jnp.where(keep, div, 0.0))
                s_log = jnp.sum(jnp.where(
                    keep, jnp.log(jnp.where(keep, div, 1.0)), 0.0))
                return s_div - s_log

            total = lax.psum(
                ring.rotate_w_sum(vals, rows, cols, H, is_terms),
                AXIS_RING,
            )
            return total - float(n) * float(m)

        def nz_terms(l, h):
            wh = sddmm(l, W, h)
            v = l.values
            keep = v > DL.EPSILON
            wh_c = jnp.maximum(wh, DL.EPSILON)
            s_xb = jnp.sum(jnp.where(
                keep, (v ** beta).astype(jnp.float32), 0.0))
            s_xwh = jnp.sum(jnp.where(
                keep, (v * wh_c ** (beta - 1.0)).astype(jnp.float32),
                0.0))
            return s_xb - beta * s_xwh

        total_nz = lax.psum(
            ring.rotate_w_sum(vals, rows, cols, H, nz_terms), AXIS_RING
        )

        # second rotation: sum (WH)^beta over all valid nm positions
        def body(s, carry):
            H_rot, acc = carry
            j = (my - s) % p
            acc = acc + _masked_sum_wh_beta(W, H_rot, row_valid, j * bc)
            H_rot = lax.ppermute(H_rot, AXIS_RING, ring.fwd)
            return (H_rot, acc)

        _, swb = lax.fori_loop(
            0, p, body, (H, jnp.asarray(0.0, jnp.float32))
        )
        swb = lax.psum(swb, AXIS_RING)
        return (total_nz + (beta - 1.0) * swb) / (beta * (beta - 1.0))

    err_sh = jax.shard_map(
        err, mesh=mesh,
        in_specs=(tiles, tiles, tiles, P(AXIS_RING, None),
                  P(None, AXIS_RING)),
        out_specs=P(),
        check_vma=False,
    )

    def beta_err(scoo, W, He):
        return err_sh(scoo.values, scoo.rows, scoo.cols, W, He)

    return beta_err
