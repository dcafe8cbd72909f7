"""Sharded gather-only ELL layout: the 2-D grid engine with ELL tiles.

Same mesh/collective structure as parallel/updates.py (W row-sharded,
H col-sharded, psum-reduced numerators — MPI-FAUN pattern), but each
device's tile is stored in the gather-only bucketed-segment layout of
nmftpu.sparse_ell instead of scatter-COO — measured ~3× faster per tile
for MU (PERF.md). SPMD requires identical per-device shapes, so every
bucket's segment count is padded to the maximum over tiles; the balancing
permutation keeps that padding small.

Both orientations are stored: row-major ELL of each tile (for V·Hᵀ) and
row-major ELL of each tile's TRANSPOSE (for (WᵀV)ᵀ).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from nmftpu import sparse as host_sparse
from nmftpu import sparse_ell as SE
from nmftpu.linalg.dense import gram_cols, gram_rows
from nmftpu.parallel.mesh import AXIS_ITEMS, AXIS_USERS
from nmftpu.sparse_ell import EllBucket, EllRows

_TILE_SEG = P(AXIS_USERS, AXIS_ITEMS, None, None)
_TILE_ROW = P(AXIS_USERS, AXIS_ITEMS, None)
_W_SPEC = P(AXIS_USERS, None)
_H_SPEC = P(None, AXIS_ITEMS)
_REP = P()


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["r_vals", "r_cols", "r_rows", "c_vals", "c_cols",
                 "c_rows"],
    meta_fields=["r_widths", "c_widths", "shape", "nnz", "mesh_shape",
                 "block_rows", "block_cols"],
)
@dataclasses.dataclass(frozen=True)
class ShardedEll:
    """Per-bucket stacked tile arrays; leading (pu, pi) axes shard over the
    mesh. r_* = row-major ELL of the tile; c_* = row-major ELL of the
    tile's transpose."""

    r_vals: tuple   # each (pu, pi, nseg_b, width_b)
    r_cols: tuple
    r_rows: tuple   # each (pu, pi, nseg_b)
    c_vals: tuple
    c_cols: tuple
    c_rows: tuple
    r_widths: tuple
    c_widths: tuple
    shape: tuple[int, int]
    nnz: int
    mesh_shape: tuple[int, int]
    block_rows: int
    block_cols: int

    @property
    def padded_shape(self):
        return (
            self.mesh_shape[0] * self.block_rows,
            self.mesh_shape[1] * self.block_cols,
        )


def _tile_segments(rows, seg_max, buckets_arr):
    """Vectorized segment split of one tile's row-sorted triplets:
    returns (seg_row, seg_off, seg_len, which_bucket), O(nnz) numpy —
    the same formulation as sparse_ell.build_ell_rows."""
    if not len(rows):
        z = np.zeros(0, np.int64)
        return z, z, z, z
    starts = np.flatnonzero(np.diff(rows, prepend=-1)).astype(np.int64)
    lens = np.diff(np.append(starts, len(rows)))
    row_ids = rows[starts].astype(np.int64)
    nseg_row = (lens + seg_max - 1) // seg_max
    seg_row = np.repeat(row_ids, nseg_row)
    first = np.repeat(np.cumsum(nseg_row) - nseg_row, nseg_row)
    k_in_row = np.arange(seg_row.size, dtype=np.int64) - first
    off = np.repeat(starts, nseg_row) + k_in_row * seg_max
    seg_len = np.minimum(np.repeat(starts + lens, nseg_row) - off, seg_max)
    which = np.searchsorted(buckets_arr, seg_len)
    return seg_row, off, seg_len, which


def _tile_ell_arrays(
    tri_by_tile, pu, pi, n_local, dtype, seg_max, buckets
):
    """Build per-tile ELL and pad segment counts to the global max.
    tri_by_tile[(i, j)] = (rows_local, cols_local, vals) sorted by row.

    Padding segments keep out_row NON-DECREASING (repeating the tile's
    last real row; their values are zero, so the add is a no-op) —
    the sparse_ell scatter-adds promise indices_are_sorted=True, and a
    zero-row pad would break that promise on the sorted-scatter path.
    """
    buckets_arr = np.asarray(buckets, dtype=np.int64)
    per_tile = {
        key: _tile_segments(tri[0], seg_max, buckets_arr)
        for key, tri in tri_by_tile.items()
    }

    widths_present = sorted({
        int(buckets[b]) for (sr, off, sl, which) in per_tile.values()
        for b in np.unique(which)
    })
    widths = tuple(widths_present) or (buckets[0],)
    bucket_index = {int(w): i for i, w in enumerate(buckets)}

    out_vals, out_cols, out_rows = [], [], []
    for w in widths:
        bi = bucket_index[w]
        counts = {
            key: int(np.count_nonzero(which == bi))
            for key, (_, _, _, which) in per_tile.items()
        }
        ns = max(max(counts.values(), default=0), 1)
        va = np.zeros((pu, pi, ns, w), dtype=np.dtype(dtype))
        ca = np.zeros((pu, pi, ns, w), dtype=np.int32)
        ra = np.zeros((pu, pi, ns), dtype=np.int32)
        for (i, j), (seg_row, off, seg_len, which) in per_tile.items():
            sel = np.flatnonzero(which == bi)
            nst = sel.size
            if nst:
                _, cols, vals = tri_by_tile[(i, j)]
                pos = off[sel][:, None] + np.arange(w)[None, :]
                valid = np.arange(w)[None, :] < seg_len[sel][:, None]
                pos = np.where(valid, pos, 0).clip(0, max(len(vals) - 1, 0))
                va[i, j, :nst] = np.where(valid, vals[pos], 0)
                ca[i, j, :nst] = np.where(valid, cols[pos], 0)
                ra[i, j, :nst] = seg_row[sel]
                ra[i, j, nst:] = int(seg_row[sel][-1])
        out_vals.append(va)
        out_cols.append(ca)
        out_rows.append(ra)
    return widths, out_vals, out_cols, out_rows


def partition_sparse_ell(
    mat: host_sparse.SparseMatrix,
    mesh_shape: tuple[int, int],
    dtype=jnp.float32,
    seg_max: int = 512,
    buckets: tuple[int, ...] = SE.DEFAULT_BUCKETS,
    balance: bool = True,
    seed: int = 0,
    mesh=None,
):
    """Tile + ELL-encode a host sparse matrix for the mesh. Returns
    (ShardedEll, row_perm, col_perm)."""
    pu, pi = mesh_shape
    coo = mat.to_coo()
    n, m = coo.shape
    rng = np.random.default_rng(seed)
    if balance:
        row_perm = rng.permutation(n).astype(np.int32)
        col_perm = rng.permutation(m).astype(np.int32)
        rows = row_perm[coo.row]
        cols = col_perm[coo.col]
    else:
        row_perm = np.arange(n, dtype=np.int32)
        col_perm = np.arange(m, dtype=np.int32)
        rows, cols = coo.row, coo.col

    def rup(x, mult=8):
        return ((x + mult - 1) // mult) * mult

    block_rows = rup((n + pu - 1) // pu)
    block_cols = rup((m + pi - 1) // pi)
    ti = rows // block_rows
    tj = cols // block_cols
    lr = (rows - ti * block_rows).astype(np.int32)
    lc = (cols - tj * block_cols).astype(np.int32)

    tri_r, tri_c = {}, {}
    for i in range(pu):
        for j in range(pi):
            sel = np.flatnonzero((ti == i) & (tj == j))
            rr, cc, vv = lr[sel], lc[sel], coo.data[sel]
            o = np.lexsort((cc, rr))
            tri_r[(i, j)] = (rr[o], cc[o], vv[o])
            o = np.lexsort((rr, cc))
            tri_c[(i, j)] = (cc[o], rr[o], vv[o])  # transpose orientation

    rw, rv, rc, rr_ = _tile_ell_arrays(
        tri_r, pu, pi, block_rows, dtype, seg_max, buckets
    )
    cw, cv, cc_, cr = _tile_ell_arrays(
        tri_c, pu, pi, block_cols, dtype, seg_max, buckets
    )

    def put(arrs, spec):
        if mesh is None:
            return tuple(jnp.asarray(a) for a in arrs)
        sh = NamedSharding(mesh, spec)
        return tuple(
            jax.make_array_from_callback(a.shape, sh,
                                         lambda idx, a=a: a[idx])
            for a in arrs
        )

    sell = ShardedEll(
        r_vals=put(rv, _TILE_SEG), r_cols=put(rc, _TILE_SEG),
        r_rows=put(rr_, _TILE_ROW),
        c_vals=put(cv, _TILE_SEG), c_cols=put(cc_, _TILE_SEG),
        c_rows=put(cr, _TILE_ROW),
        r_widths=rw, c_widths=cw,
        shape=(n, m), nnz=coo.nnz, mesh_shape=(pu, pi),
        block_rows=block_rows, block_cols=block_cols,
    )
    return sell, row_perm, col_perm


def _local_ell(widths, vals, cols, rows, shape, nnz=-1) -> EllRows:
    """Assemble the device-local EllRows inside a shard_map region."""
    return EllRows(
        buckets=tuple(
            EllBucket(
                vals=v[0, 0], cols=c[0, 0], out_row=r[0, 0], width=w
            )
            for w, v, c, r in zip(widths, vals, cols, rows)
        ),
        shape=shape, nnz=nnz,
    )


def build_sharded_ell_update(config, mesh, sell: ShardedEll):
    """Sharded MU updates over ELL tiles. Returns (make_aux, update,
    effective_h) for the generic loop; MU Frobenius/KL/weighted/beta."""
    from nmftpu.config import Algorithm, Objective

    if config.algorithm is not Algorithm.MU:
        raise ValueError("sharded ELL engine supports the MU family")
    eps = config.eps
    order = config.update_order
    obj = config.objective
    alpha = config.alpha_confidence
    br, bc = sell.block_rows, sell.block_cols
    rshape = (br, bc)
    cshape = (bc, br)

    nr = len(sell.r_widths)

    def step(*args):
        (r_vals, r_cols, r_rows) = (args[0:nr], args[nr:2 * nr],
                                    args[2 * nr:3 * nr])
        rest = args[3 * nr:]
        nc = len(sell.c_widths)
        (c_vals, c_cols, c_rows) = (rest[0:nc], rest[nc:2 * nc],
                                    rest[2 * nc:3 * nc])
        W, H = rest[3 * nc], rest[3 * nc + 1]

        ell_r = _local_ell(sell.r_widths, r_vals, r_cols, r_rows, rshape)
        ell_c = _local_ell(sell.c_widths, c_vals, c_cols, c_rows, cshape)

        def numer_w(H):
            return lax.psum(SE.v_ht_ell(ell_r, H), AXIS_ITEMS)

        def numer_h(W):
            return lax.psum(
                SE.v_ht_ell(ell_c, jnp.asarray(W).T).T, AXIS_USERS
            )

        if obj is Objective.FROBENIUS and alpha > 0.0:
            # fused gather-once per tile (sampled_rowsums_ell): one table
            # gather serves the weighted numerator AND the alpha term
            wfns = (
                lambda v, s: v * (1.0 + alpha * v),
                lambda v, s: v * s,
            )

            def upd_w(W, H):
                numer, alpha_part = SE.sampled_rowsums_ell(
                    ell_r, W, H, wfns
                )
                HHt = lax.psum(gram_rows(H), AXIS_ITEMS)
                den = (
                    W @ HHt
                    + alpha * lax.psum(alpha_part, AXIS_ITEMS)
                    + eps
                )
                return W * (lax.psum(numer, AXIS_ITEMS) / den)

            def upd_h(W, H):
                Wt = jnp.asarray(W).T
                numer, alpha_part = SE.sampled_rowsums_ell(
                    ell_c, jnp.asarray(H).T, Wt, wfns
                )
                WtW = lax.psum(gram_cols(W), AXIS_USERS)
                den = (
                    WtW @ H
                    + alpha * lax.psum(alpha_part.T, AXIS_USERS)
                    + eps
                )
                return H * (lax.psum(numer.T, AXIS_USERS) / den)

        elif obj is Objective.FROBENIUS:

            def upd_w(W, H):
                HHt = lax.psum(gram_rows(H), AXIS_ITEMS)
                return W * (numer_w(H) / (W @ HHt + eps))

            def upd_h(W, H):
                WtW = lax.psum(gram_cols(W), AXIS_USERS)
                return H * (numer_h(W) / (WtW @ H + eps))

        elif obj is Objective.BETA:
            # Generalized beta-MU on ELL tiles: the numerator is the
            # same fused gather-once transform(SDDMM)+SpMM as KL with
            # the coefficient v * clamp(WH)^(beta-2) (sklearn's
            # numerator guard: clamp up to EPSILON when beta < 2; ELL
            # padding lanes carry v = 0, so their garbage sample is
            # multiplied away); the dense-in-FLOPs denominator streams
            # per-device (W H_local)^(beta-1) panels and psums over the
            # mesh axis — the same collective pattern as the scatter
            # grid engine (updates._upd_w_beta, linalg.dense
            # .mu_update_beta is the oracle).
            from nmftpu.linalg import dense as DL
            from nmftpu.sparse_ops import (beta_denom_h_blocked,
                                           beta_denom_w_blocked)

            b_ = config.beta
            gamma = DL.beta_gamma(b_)
            if b_ == 0.0:
                def coef(v, s):
                    sc = jnp.maximum(s, DL.EPSILON)
                    return v / (sc * sc)
            elif b_ < 2.0:
                def coef(v, s):
                    return v * jnp.maximum(s, DL.EPSILON) ** (b_ - 2.0)
            else:
                def coef(v, s):
                    return v * s ** (b_ - 2.0)
            cfns = (coef,)

            def _finish(X, numer, denom):
                denom = jnp.where(denom == 0.0, DL.EPSILON, denom)
                d = numer / denom
                if gamma != 1.0:
                    d = d ** gamma
                out = X * d
                if b_ < 1.0:
                    out = jnp.where(out < DL._STAB_EPS, 0.0, out)
                return out

            def upd_w(W, H):
                numer, = SE.sampled_rowsums_ell(ell_r, W, H, cfns)
                numer = lax.psum(numer, AXIS_ITEMS)
                blk = max(1, min(2048, H.shape[1]))
                denom = lax.psum(
                    beta_denom_w_blocked(W, H, b_, blk), AXIS_ITEMS
                )
                return _finish(W, numer, denom)

            def upd_h(W, H):
                Wt = jnp.asarray(W).T
                numer, = SE.sampled_rowsums_ell(
                    ell_c, jnp.asarray(H).T, Wt, cfns
                )
                numer = lax.psum(numer.T, AXIS_USERS)
                blk = max(1, min(2048, W.shape[0]))
                denom = lax.psum(
                    beta_denom_h_blocked(W, H, b_, blk), AXIS_USERS
                )
                return _finish(H, numer, denom)

        else:  # KL — fused gather-once ratio+SpMM per tile
            rfns = (lambda v, s: v / (s + eps),)

            def upd_w(W, H):
                numer, = SE.sampled_rowsums_ell(ell_r, W, H, rfns)
                h_sum = lax.psum(jnp.sum(H, axis=1), AXIS_ITEMS)
                numer = lax.psum(numer, AXIS_ITEMS)
                return W * (numer / jnp.maximum(h_sum, eps)[None, :])

            def upd_h(W, H):
                Wt = jnp.asarray(W).T
                numer, = SE.sampled_rowsums_ell(
                    ell_c, jnp.asarray(H).T, Wt, rfns
                )
                w_sum = lax.psum(jnp.sum(W, axis=0), AXIS_USERS)
                numer = lax.psum(numer.T, AXIS_USERS)
                return H * (numer / jnp.maximum(w_sum, eps)[:, None])

        if order == "WH":
            W = upd_w(W, H)
            H = upd_h(W, H)
        else:
            H = upd_h(W, H)
            W = upd_w(W, H)
        return W, H

    nc = len(sell.c_widths)
    in_specs = (
        (_TILE_SEG,) * nr + (_TILE_SEG,) * nr + (_TILE_ROW,) * nr
        + (_TILE_SEG,) * nc + (_TILE_SEG,) * nc + (_TILE_ROW,) * nc
        + (_W_SPEC, _H_SPEC)
    )
    shmapped = jax.shard_map(
        step, mesh=mesh, in_specs=in_specs,
        out_specs=(_W_SPEC, _H_SPEC), check_vma=False,
    )

    def update(sell_op, aux, W, H):
        return shmapped(
            *sell_op.r_vals, *sell_op.r_cols, *sell_op.r_rows,
            *sell_op.c_vals, *sell_op.c_cols, *sell_op.c_rows,
            W, H,
        )

    return (lambda s: ()), update, (lambda aux, H: H)


def build_sharded_ell_errors(mesh, sell: ShardedEll):
    """(frobenius, kl) over ELL tiles, replicated scalars out."""
    nr = len(sell.r_widths)
    nc = len(sell.c_widths)
    rshape = (sell.block_rows, sell.block_cols)
    cshape = (sell.block_cols, sell.block_rows)

    def fro(*args):
        c_vals = args[0:nc]
        c_cols = args[nc:2 * nc]
        c_rows = args[2 * nc:3 * nc]
        W, H, svsq = args[3 * nc], args[3 * nc + 1], args[3 * nc + 2]
        ell_c = _local_ell(sell.c_widths, c_vals, c_cols, c_rows, cshape)
        WtV = lax.psum(SE.v_ht_ell(ell_c, jnp.asarray(W).T).T, AXIS_USERS)
        cross = lax.psum(jnp.sum(WtV * H), AXIS_ITEMS)
        WtW = lax.psum(gram_cols(W), AXIS_USERS)
        HHt = lax.psum(gram_rows(H), AXIS_ITEMS)
        return jnp.sqrt(jnp.maximum(
            svsq[0] - 2.0 * cross + jnp.sum(WtW * HHt), 0.0
        ))

    fro_sh = jax.shard_map(
        fro, mesh=mesh,
        in_specs=(
            (_TILE_SEG,) * nc + (_TILE_SEG,) * nc + (_TILE_ROW,) * nc
            + (_W_SPEC, _H_SPEC, _REP)
        ),
        out_specs=_REP, check_vma=False,
    )

    def kl(*args):
        r_vals = args[0:nr]
        r_cols = args[nr:2 * nr]
        r_rows = args[2 * nr:3 * nr]
        W, H = args[3 * nr], args[3 * nr + 1]
        ell_r = _local_ell(sell.r_widths, r_vals, r_cols, r_rows, rshape)
        s = SE.sddmm_ell(ell_r, W, H)
        local = jnp.asarray(0.0, jnp.float32)
        for orig, samp in zip(ell_r.buckets, s.buckets):
            v = orig.vals
            wh = samp.vals
            term = jnp.where(
                v > 0,
                v * jnp.log(jnp.maximum(v, 1e-12)
                            / jnp.maximum(wh, 1e-12)),
                0.0,
            )
            local = local + jnp.sum(term) - jnp.sum(v)
        total = lax.psum(lax.psum(local, AXIS_USERS), AXIS_ITEMS)
        w_col = lax.psum(jnp.sum(W, axis=0), AXIS_USERS)
        h_row = lax.psum(jnp.sum(H, axis=1), AXIS_ITEMS)
        return total + w_col @ h_row

    kl_sh = jax.shard_map(
        kl, mesh=mesh,
        in_specs=(
            (_TILE_SEG,) * nr + (_TILE_SEG,) * nr + (_TILE_ROW,) * nr
            + (_W_SPEC, _H_SPEC)
        ),
        out_specs=_REP, check_vma=False,
    )

    def frobenius(sell_op, W, He, svsq):
        return fro_sh(
            *sell_op.c_vals, *sell_op.c_cols, *sell_op.c_rows,
            W, He, jnp.reshape(svsq, (1,)),
        )

    def kl_err(sell_op, W, He):
        return kl_sh(
            *sell_op.r_vals, *sell_op.r_cols, *sell_op.r_rows, W, He,
        )

    return frobenius, kl_err


def build_sharded_ell_beta_error(mesh, sell: ShardedEll, beta: float):
    """D_beta(V || WH) over ELL tiles, sklearn's sparse-X semantics
    (twin of updates.build_sharded_beta_error): stored-set terms from
    the per-bucket SDDMM samples (padding lanes carry v = 0 and are
    dropped by the keep mask), the zero-position term sum (WH)^beta
    from the shared per-tile panel streamer (updates.sum_wh_beta_tile,
    pad rows/cols masked). Replicated scalar out."""
    from nmftpu.linalg import dense as DL
    from nmftpu.parallel.updates import sum_wh_beta_tile

    nr = len(sell.r_widths)
    n, m = sell.shape
    br, bc = sell.block_rows, sell.block_cols
    rshape = (br, bc)

    def beta_err(*args):
        r_vals = args[0:nr]
        r_cols = args[nr:2 * nr]
        r_rows = args[2 * nr:3 * nr]
        W, H = args[3 * nr], args[3 * nr + 1]
        ell_r = _local_ell(sell.r_widths, r_vals, r_cols, r_rows, rshape)
        s = SE.sddmm_ell(ell_r, W, H)
        if beta == 0.0:
            local = jnp.asarray(0.0, jnp.float32)
            for orig, samp in zip(ell_r.buckets, s.buckets):
                v = orig.vals
                keep = v > DL.EPSILON
                wh_c = jnp.maximum(samp.vals, DL.EPSILON)
                div = (v / wh_c).astype(jnp.float32)
                local = local + jnp.sum(jnp.where(keep, div, 0.0))
                local = local - jnp.sum(jnp.where(
                    keep, jnp.log(jnp.where(keep, div, 1.0)), 0.0))
            total = lax.psum(lax.psum(local, AXIS_USERS), AXIS_ITEMS)
            return total - float(n) * float(m)
        local = jnp.asarray(0.0, jnp.float32)
        for orig, samp in zip(ell_r.buckets, s.buckets):
            v = orig.vals
            keep = v > DL.EPSILON
            wh_c = jnp.maximum(samp.vals, DL.EPSILON)
            local = local + jnp.sum(jnp.where(
                keep, (v ** beta).astype(jnp.float32), 0.0))
            local = local - beta * jnp.sum(jnp.where(
                keep, (v * wh_c ** (beta - 1.0)).astype(jnp.float32),
                0.0))
        local = local + (beta - 1.0) * sum_wh_beta_tile(
            W, H, beta, n, m, br, bc
        )
        total = lax.psum(lax.psum(local, AXIS_USERS), AXIS_ITEMS)
        return total / (beta * (beta - 1.0))

    beta_sh = jax.shard_map(
        beta_err, mesh=mesh,
        in_specs=(
            (_TILE_SEG,) * nr + (_TILE_SEG,) * nr + (_TILE_ROW,) * nr
            + (_W_SPEC, _H_SPEC)
        ),
        out_specs=_REP, check_vma=False,
    )

    def err(sell_op, W, He):
        return beta_sh(
            *sell_op.r_vals, *sell_op.r_cols, *sell_op.r_rows, W, He,
        )

    return err
