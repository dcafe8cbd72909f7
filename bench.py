#!/usr/bin/env python
"""Benchmark harness: dense MU update-step GFLOP/s on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...,
"device"}.

The cell is the dense MU (Frobenius) update step — the reference's hot
loop (SURVEY.md §3.2) — at 4096 x 4096, rank 256. The anchor is the
plain f32 jnp update; `value` is the best of the library's dense routes
as `nmftpu.algorithms.registry` builds them (f32 V, int8-stored V), so
vs_baseline tracks what a user of `v_storage` gets over the anchor.

Timing: k iterations inside one jitted `lax.fori_loop`, ended by
`block_until_ready`, median of `--reps` runs after a compile run.
Refuses to run without a GPU: a CPU rate is not a device metric.
"""

import argparse
import json
import sys
import time

import numpy as np


def _mu_flops_per_iter(n, m, r):
    # V H^T + W^T V (2 * 2nmr) + Grams and their applications
    # (2 * (2nr^2 + 2mr^2)) + elementwise O(nr + mr)
    return 4 * n * m * r + 4 * n * r * r + 4 * m * r * r + 3 * (n * r + m * r)


def bench_dense_mu(n, m, r, iters, reps, v_storage):
    """(GFLOP/s, compile seconds, spread) of the registry's MU update
    with V stored as `v_storage`; spread is (max - min) / median."""
    import jax
    import jax.numpy as jnp

    from nmftpu.algorithms.registry import build_dense_update
    from nmftpu.config import NmfConfig

    rng = np.random.default_rng(0)
    V = jnp.asarray(rng.uniform(0.1, 1.0, (n, m)), jnp.float32)
    W0 = jnp.asarray(rng.uniform(0.1, 1.0, (n, r)), jnp.float32)
    H0 = jnp.asarray(rng.uniform(0.1, 1.0, (r, m)), jnp.float32)
    make_aux, update, _ = build_dense_update(
        NmfConfig(rank=r, v_storage=v_storage))
    aux = make_aux(V)

    @jax.jit
    def run(V, aux, W, H):
        return jax.lax.fori_loop(
            0, iters, lambda _, c: update(V, aux, *c), (W, H))

    t0 = time.perf_counter()
    jax.block_until_ready(run(V, aux, W0, H0))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(V, aux, W0, H0))
        ts.append((time.perf_counter() - t0) / iters)
    med = float(np.median(ts))
    rate = _mu_flops_per_iter(n, m, r) / med / 1e9
    return rate, compile_s, (max(ts) - min(ts)) / med


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--rank", type=int, default=256)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument(
        "--assert-floor", type=float, default=None, metavar="GFLOPS",
        help="exit nonzero if the measured rate falls below this floor "
             "(a perf-regression gate, SURVEY.md §4.5)",
    )
    args = ap.parse_args()

    import jax

    from nmftpu import backend

    cache = backend.use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's device is "
                 f"{dev.platform}")
    print(f"benchmarking on {dev.device_kind}; compile cache {cache}",
          file=sys.stderr)

    rates, spreads = {}, {}
    for v_storage in ("float32", "int8"):
        rates[v_storage], compile_s, spreads[v_storage] = bench_dense_mu(
            args.n, args.m, args.rank, args.iters, args.reps, v_storage)
        print(f"v_storage={v_storage}: {rates[v_storage]:.0f} GFLOP/s "
              f"(compile {compile_s:.2f} s, spread "
              f"{spreads[v_storage] * 100:.1f}%)", file=sys.stderr)
    baseline = rates["float32"]
    best = max(rates, key=rates.get)
    value = rates[best]
    print(json.dumps({
        "metric": "mu_update_gflops_per_chip",
        "value": round(value, 2),
        "unit": "GFLOP/s",
        "vs_baseline": round(value / baseline, 4),
        "best": best,
        "spread": round(spreads[best], 3),
        "baseline_spread": round(spreads["float32"], 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    if args.assert_floor is not None and value < args.assert_floor:
        sys.exit(f"PERF REGRESSION: {value:.0f} GFLOP/s below floor "
                 f"{args.assert_floor:.0f}")


if __name__ == "__main__":
    main()
