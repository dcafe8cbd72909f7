"""2-D tiled sparse layout for the device mesh.

Each mesh cell (i, j) owns the nonzeros of V falling in row block i and
column block j, stored with block-LOCAL indices, zero-padded to the
uniform per-tile capacity (max tile nnz rounded up to the chunk size) so
the per-device shapes are identical — the static-shape requirement of
SPMD. Padding entries (value 0, indices 0) are exact no-ops in every
primitive, identical to the single-device DeviceCOO contract.

Load balance (SURVEY.md §7 hard parts): power-law matrices give wildly
uneven tiles; `partition_sparse(balance=True)` applies a deterministic
pseudo-random permutation to rows and columns before tiling, which
equalizes tile populations to within a few percent. The permutations are
returned so factors can be un-permuted on the way out.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from nmftpu import sparse as host_sparse
from nmftpu.sparse_ops import DeviceCOO


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["values", "rows", "cols"],
    meta_fields=[
        "shape", "nnz", "chunk", "mesh_shape", "block_rows", "block_cols",
    ],
)
@dataclasses.dataclass(frozen=True)
class ShardedCOO:
    """Tiled sparse V: leading (pu, pi) axes are sharded over the mesh."""

    values: jax.Array   # (pu, pi, Nt)
    rows: jax.Array     # (pu, pi, Nt) int32 — LOCAL row index within block
    cols: jax.Array     # (pu, pi, Nt) int32 — LOCAL col index within block
    shape: tuple[int, int]   # true (unpadded) global shape
    nnz: int
    chunk: int
    mesh_shape: tuple[int, int]
    block_rows: int
    block_cols: int

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (
            self.mesh_shape[0] * self.block_rows,
            self.mesh_shape[1] * self.block_cols,
        )

    def local_coo_template(self) -> DeviceCOO:
        """Metadata-only DeviceCOO describing one tile (for local ops)."""
        return DeviceCOO(
            values=None, rows=None, cols=None,
            shape=(self.block_rows, self.block_cols),
            nnz=-1, chunk=self.chunk,
        )


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def partition_sparse(
    mat: host_sparse.SparseMatrix,
    mesh_shape: tuple[int, int],
    dtype=jnp.float32,
    chunk: int = 8192,
    balance: bool = True,
    seed: int = 0,
    out_shardings=None,
):
    """Tile a host sparse matrix over a (pu, pi) mesh grid.

    Returns (ShardedCOO, row_perm, col_perm) where the permutations map
    ORIGINAL index -> PERMUTED index (identity when balance=False). Factors
    learned under the permutation satisfy W_perm[row_perm] = rows in
    permuted order; undo with W_orig = W_perm[...] indexed by row_perm.
    """
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

    block_rows = _round_up((n + pu - 1) // pu, 8)
    block_cols = _round_up((m + pi - 1) // pi, 8)

    tile_r = rows // block_rows
    tile_c = cols // block_cols
    tile_id = tile_r * pi + tile_c
    counts = np.bincount(tile_id, minlength=pu * pi)
    cap = max(int(counts.max()), 1)
    chunk = min(chunk, _round_up(cap, 256))
    cap = _round_up(cap, chunk)

    values = np.zeros((pu, pi, cap), dtype=np.dtype(dtype))
    lrows = np.zeros((pu, pi, cap), dtype=np.int32)
    lcols = np.zeros((pu, pi, cap), dtype=np.int32)

    # Grouping by tile: the key space is tiny (pu*pi values), so ONE
    # boolean scan per tile replaces the O(nnz log nnz) stable argsort —
    # and the resulting selections are SORTED, so the gathers below run
    # monotonically instead of randomly (measured ~3x on the 100M-nnz
    # partition; scripts/bench_host_partition.py).
    for t in range(pu * pi):
        sel = np.flatnonzero(tile_id == t)
        k = len(sel)
        ti, tj = divmod(t, pi)
        values[ti, tj, :k] = coo.data[sel]
        lrows[ti, tj, :k] = rows[sel] - ti * block_rows
        lcols[ti, tj, :k] = cols[sel] - tj * block_cols

    def put(x):
        if out_shardings is not None:
            # make_array_from_callback materializes only the shards owned
            # by this process's devices — multi-host safe (each host needs
            # only its own tiles in memory).
            return jax.make_array_from_callback(
                x.shape, out_shardings, lambda idx: x[idx]
            )
        return jnp.asarray(x)

    scoo = ShardedCOO(
        values=put(values),
        rows=put(lrows),
        cols=put(lcols),
        shape=(n, m),
        nnz=coo.nnz,
        chunk=chunk,
        mesh_shape=(pu, pi),
        block_rows=block_rows,
        block_cols=block_cols,
    )
    return scoo, row_perm, col_perm


def balance_report(scoo: ShardedCOO) -> dict:
    """Tile-population statistics (padding waste, max/mean imbalance)."""
    nz = np.asarray(jnp.sum((scoo.values != 0), axis=-1))
    cap = scoo.values.shape[-1]
    return {
        "tile_capacity": int(cap),
        "tile_nnz_max": int(nz.max()),
        "tile_nnz_min": int(nz.min()),
        "tile_nnz_mean": float(nz.mean()),
        "imbalance": float(nz.max() / max(nz.mean(), 1e-9)),
        "padding_fraction": float(1.0 - nz.sum() / (nz.size * cap)),
    }
