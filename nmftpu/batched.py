"""Batched multi-problem NMF: factorize a STACK of matrices in one
compiled program.

Production recommenders routinely fit one small model per segment
(per region, per category, per tenant); issuing B separate device
programs wastes the device on launch gaps and leaves it under-tiled at
small (n, m). Here the whole stack runs as `vmap` over the SAME
on-device while-loop the single-problem driver uses (nmftpu.loop) —
XLA batches every GEMM to (B, n, r) x (B, r, m) contractions that tile
the tensor cores properly, and the host dispatches once.

Semantics: problem i runs the same update loop as `compute`, seeded
with `fold_in(PRNGKey(seed), i)` — the SAME key rule the solo driver
uses for its i-th restart. So problem 0 is bit-equal to a plain
`compute(Vs[0], config)` call, and any problem i is bit-equal to a
solo run warm-started from `initialize_factors(Vs[i], ...,
fold_in(key, i))` (asserted in tests/test_batched.py); a naive
`compute(Vs[i], config)` differs for i>0 only in the random init draw.
The batching win is an accelerator property (dispatch gaps and GEMM
tiling at small n/m); on CPU, B cached solo calls can be faster —
measure before batching there. Early-stop thresholds are rejected: under vmap
a while-loop runs until EVERY problem's predicate clears, so per-
problem stopping would silently over-iterate converged problems; run
fixed budgets (threshold_value=0) — the normal setting for sweeps.

No reference counterpart (nmfgpu is one-matrix-per-call; SURVEY.md C2).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from nmftpu.config import Initialization, NmfConfig, Objective, resolve_dtype
from nmftpu.driver import _dense_ops
from nmftpu.init import initialize_factors
from nmftpu.loop import RunStats, build_runner

__all__ = ["BatchedNmfResult", "compute_batched"]

_BATCHED_RUNNER_CACHE: dict = {}


class BatchedNmfResult:
    """Stacked factors + per-problem metadata for a batched run.

    W: (B, n, r), H: (B, r, m); errors etc. are (B,) arrays.
    `result[i]` returns a plain per-problem view (W_i, H_i, error_i).
    """

    def __init__(self, W, H, error, frobenius_error, rmsd, kl_error,
                 num_iterations, converged, elapsed_ms, stats):
        self.W = W
        self.H = H
        self.error = error
        self.frobenius_error = frobenius_error
        self.rmsd = rmsd
        self.kl_error = kl_error
        self.num_iterations = num_iterations
        self.converged = converged
        self.elapsed_ms = elapsed_ms
        self.stats = stats

    def __len__(self):
        return self.W.shape[0]

    def __getitem__(self, i):
        return {
            "W": self.W[i],
            "H": self.H[i],
            "error": float(self.error[i]),
            "frobenius_error": float(self.frobenius_error[i]),
            "rmsd": float(self.rmsd[i]),
            "kl_error": (
                None if self.kl_error is None else float(self.kl_error[i])
            ),
            "num_iterations": int(self.num_iterations[i]),
            "converged": bool(self.converged[i]),
        }


_HOST_INITS = (
    Initialization.NNDSVD,
    Initialization.NNDSVDA,
    Initialization.NNDSVDAR,
)


def compute_batched(
    Vs,
    config: NmfConfig,
    W0=None,
    H0=None,
) -> BatchedNmfResult:
    """Factorize every slab of ``Vs`` (B, n, m) under one config.

    W0/H0: optional (B, n, r) / (B, r, m) warm starts (required for
    COPY_EXISTING). Each problem gets its own seeded init key
    (fold_in by problem index), so results match B independent
    `compute` calls exactly.
    """
    if config.num_runs != 1:
        raise ValueError(
            "compute_batched runs one restart per problem (the batch "
            "axis IS the parallelism); use num_runs=1 and vary seed, "
            "or the single-problem driver for best-of-N"
        )
    if config.threshold_value > 0:
        raise ValueError(
            "compute_batched runs fixed iteration budgets "
            "(threshold_value=0): under vmap the while-loop runs until "
            "EVERY problem clears, so per-problem early stop would "
            "silently over-iterate the converged ones"
        )
    if config.verbosity >= 2:
        raise ValueError(
            "per-check verbosity callbacks are per-problem host prints "
            "— meaningless interleaved under vmap; use verbosity<=1 "
            "and read result.stats per problem instead"
        )
    dtype = resolve_dtype(config.dtype)
    Vs = jnp.asarray(Vs, dtype)
    if Vs.ndim != 3:
        raise ValueError(f"Vs must be (B, n, m), got shape {Vs.shape}")
    B, n, m = Vs.shape
    if config.rank > min(n, m):
        raise ValueError(
            f"rank {config.rank} exceeds min problem dims {(n, m)}"
        )

    t0 = time.perf_counter()
    root = jax.random.PRNGKey(config.seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(
        jnp.arange(B)
    )

    def one_init(V, key, W0i, H0i):
        return initialize_factors(
            V, config.rank, config.init_method, key, W0=W0i, H0=H0i,
            kmeans_max_iter=config.kmeans_max_iter,
        )

    if config.init_method in _HOST_INITS:
        # NNDSVD is a host-side SVD — per-problem loop, one-time cost
        pairs = [
            one_init(Vs[i], keys[i],
                     None if W0 is None else jnp.asarray(W0[i], dtype),
                     None if H0 is None else jnp.asarray(H0[i], dtype))
            for i in range(B)
        ]
        Ws = jnp.stack([p[0] for p in pairs])
        Hs = jnp.stack([p[1] for p in pairs])
    else:
        W0s = None if W0 is None else jnp.asarray(W0, dtype)
        H0s = None if H0 is None else jnp.asarray(H0, dtype)
        Ws, Hs = jax.vmap(one_init)(Vs, keys, W0s, H0s)

    key = (config, Vs.shape, str(dtype))
    batched = _BATCHED_RUNNER_CACHE.get(key)
    if batched is None:
        ops = _dense_ops(config)
        run = build_runner(config, ops, None, jit_wrap=False)
        batched = jax.jit(jax.vmap(run), donate_argnums=(1, 2))
        _BATCHED_RUNNER_CACHE[key] = batched
    (W, H, err, fro, kl, _compare, it, converged, stats, nc) = batched(
        Vs, Ws, Hs, jnp.arange(B)
    )
    fro_np = np.asarray(fro, np.float64)
    stats_np = np.asarray(stats)
    nc_np = np.asarray(nc)
    return BatchedNmfResult(
        W=W,
        H=H,
        error=np.asarray(err, np.float64),
        frobenius_error=fro_np,
        rmsd=fro_np / np.sqrt(float(n) * float(m)),
        kl_error=(
            np.asarray(kl, np.float64)
            if config.objective is not Objective.FROBENIUS else None
        ),
        num_iterations=np.asarray(it),
        converged=np.asarray(converged),
        elapsed_ms=(time.perf_counter() - t0) * 1e3,
        stats=[
            RunStats(
                # int64 like the solo driver's RunStats (callers index
                # with these)
                iterations=stats_np[i, : nc_np[i], 0].astype(np.int64),
                errors=stats_np[i, : nc_np[i], 1],
                deltas=stats_np[i, : nc_np[i], 2],
            )
            for i in range(B)
        ],
    )
