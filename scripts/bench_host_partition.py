"""cfg4 host-path scale proof (round-3 verdict item 6): measure the
host-side costs that gate BASELINE config #4 (100M x 10M sparse) —
`partition_sparse` tiling and the ELL bucket build — at 10M/30M/100M
nonzeros, single process, vectorized numpy.

Run with JAX_PLATFORMS=cpu (the cost under test is host CPU, not the
device). Writes chiprun_out/host_partition.json.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from nmftpu.parallel.mesh import factor_shardings, make_grid_mesh
    from nmftpu.parallel.sharded_coo import partition_sparse
    from nmftpu.sparse import SparseCOO
    from nmftpu.sparse_ell import build_ell_rows

    mesh = make_grid_mesh((2, 4))
    sh = factor_shardings(mesh)
    out = {"host": "single-process numpy", "mesh": [2, 4]}

    for nnz, n, m in (
        (10_000_000, 1_000_000, 200_000),
        (30_000_000, 3_000_000, 500_000),
        (100_000_000, 10_000_000, 1_000_000),
    ):
        rng = np.random.default_rng(0)
        # power-law-ish rows: mixture of uniform + hot rows
        rows = rng.integers(0, n, nnz).astype(np.int64)
        hot = rng.integers(0, n // 100, nnz // 5)
        rows[: len(hot)] = hot
        cols = rng.integers(0, m, nnz).astype(np.int64)
        vals = rng.uniform(0.5, 5.0, nnz).astype(np.float32)
        coo = SparseCOO(rows, cols, vals, (n, m))
        label = f"{nnz//1_000_000}M"

        t0 = time.perf_counter()
        scoo, rp, cp = partition_sparse(
            coo, (2, 4), chunk=8192, balance=True, seed=0,
            out_shardings=sh["tile"],
        )
        t_part = time.perf_counter() - t0
        pad = scoo.values.shape[2] * 8 / nnz

        t0 = time.perf_counter()
        ell = build_ell_rows(coo)
        t_ell = time.perf_counter() - t0
        ell_pad = sum(
            b.vals.shape[0] * b.width for b in ell.buckets) / nnz

        out[label] = {
            "nnz": nnz, "shape": [n, m],
            "partition_s": round(t_part, 2),
            "partition_nnz_per_s": round(nnz / t_part / 1e6, 1),
            "tile_padding": round(pad, 3),
            "ell_build_s": round(t_ell, 2),
            "ell_nnz_per_s": round(nnz / t_ell / 1e6, 1),
            "ell_padding": round(ell_pad, 3),
        }
        print(f"{label}: partition {t_part:.1f}s "
              f"({nnz/t_part/1e6:.0f}M nnz/s, pad {pad:.2f}x), "
              f"ell build {t_ell:.1f}s "
              f"({nnz/t_ell/1e6:.0f}M nnz/s, pad {ell_pad:.2f}x)",
              flush=True)
        del scoo, ell, coo, rows, cols, vals

    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "host_partition.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
