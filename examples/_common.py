"""Shared helpers for the example scripts."""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# NMFTPU_PLATFORM=cpu runs an example on the CPU on a machine that has a
# GPU (JAX would otherwise pick the GPU).
_plat = os.environ.get("NMFTPU_PLATFORM")
if _plat:
    os.environ["JAX_PLATFORMS"] = _plat
    import jax

    jax.config.update("jax_platforms", _plat)


def base_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--data", default=None,
                    help="path to a MovieLens ratings file")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--log", default=None, help="JSONL metrics path")
    return ap


def load_or_synthesize(data_path, n, m, nnz, seed=0, implicit=False):
    """Real MovieLens interactions if --data given, else synthetic."""
    from nmftpu.data import load_movielens, synthetic_powerlaw_sparse

    if data_path:
        inter = load_movielens(data_path, implicit=implicit)
        print(f"loaded {data_path}: {inter.n_users} users x "
              f"{inter.n_items} items, {inter.matrix.nnz} interactions")
        return inter
    from nmftpu.data.movielens import Interactions
    import numpy as np

    sp = synthetic_powerlaw_sparse(n, m, nnz=nnz, seed=seed)
    if implicit:
        sp.data[:] = 1.0
    print(f"synthetic fallback: {n} x {m}, {sp.nnz} interactions")
    rng = np.random.default_rng(seed)
    return Interactions(
        matrix=sp,
        user_ids=np.arange(n),
        item_ids=np.arange(m),
        timestamps=rng.integers(1, 10**9, sp.nnz),
    )
