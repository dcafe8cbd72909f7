"""Jitted Lloyd's k-means over the columns of V (SURVEY.md C8, §3.4).

The reference runs GPU k-means to seed W: columns of V (each an n-vector)
are clustered into `rank` groups and W's columns become the centroids.
Here the assignment step is a (m, r) distance argmin driven by a V^T C
matmul and the centroid update is a one-hot matmul (a dense
segment-sum that XLA maps well), so the whole loop jits into a
`lax.fori_loop` with no host round-trips.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("rank", "max_iter"))
def kmeans_columns(V, rank: int, key, max_iter: int = 25):
    """Cluster the m columns of V (n, m) into `rank` centroids.

    Returns (centroids (n, rank), assignments (m,)). Initial centroids are
    `rank` distinct random columns of V. Empty clusters keep their previous
    centroid (the reference's behavior for degenerate clusters is unknown;
    keeping the stale centroid is the standard stable choice).
    """
    n, m = V.shape
    dtype = V.dtype
    cols = jax.random.choice(key, m, shape=(rank,), replace=False)
    centroids = V[:, cols]                                # (n, r)

    col_sq = jnp.sum(V * V, axis=0)                       # (m,)

    def assign(centroids):
        # dist^2(j, k) = ||v_j||^2 - 2 v_j.c_k + ||c_k||^2 ; the argmin over
        # k drops the ||v_j||^2 term but we keep it for a true distance.
        cross = V.T @ centroids                           # (m, r)
        cent_sq = jnp.sum(centroids * centroids, axis=0)  # (r,)
        d2 = col_sq[:, None] - 2.0 * cross + cent_sq[None, :]
        return jnp.argmin(d2, axis=1)                     # (m,)

    def body(_, centroids):
        labels = assign(centroids)
        onehot = jax.nn.one_hot(labels, rank, dtype=dtype)  # (m, r)
        sums = V @ onehot                                   # (n, r)
        counts = jnp.sum(onehot, axis=0)                    # (r,)
        new = sums / jnp.maximum(counts, 1.0)[None, :]
        return jnp.where(counts[None, :] > 0, new, centroids)

    centroids = jax.lax.fori_loop(0, max_iter, body, centroids)
    return centroids, assign(centroids)
