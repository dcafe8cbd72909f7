"""Command-line interface: `python -m nmftpu <ratings-file>`.

Factorizes a MovieLens-format interaction file (or a .npy dense matrix),
reports convergence, and optionally writes the factor tables / a serving
bundle and a recall@k evaluation — the whole graded pipeline from a shell.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="nmftpu",
        description="NMF recommender-embedding engine in JAX",
    )
    ap.add_argument("data", help="ratings file (u.data / ratings.csv) "
                                 "or .npy dense matrix")
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--algorithm", default="mu")
    ap.add_argument("--objective", default="frobenius",
                    help="frobenius | kl | itakura-saito | beta "
                         "(with --beta)")
    ap.add_argument("--beta", type=float, default=None,
                    help="beta-divergence exponent for --objective beta")
    ap.add_argument("--init", default="all_random_values")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--threshold", type=float, default=0.0)
    ap.add_argument("--threshold-type", default="frobenius")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--alpha-confidence", type=float, default=0.0)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "float64"],
                    help="factor dtype (float64 = the reference's double "
                         "precision; requires JAX_ENABLE_X64=1)")
    ap.add_argument("--v-storage", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="dense-V device storage: bfloat16 halves / int8 "
                         "quarters traffic")
    ap.add_argument("--strategy", default="auto",
                    choices=["auto", "densified", "ell", "scatter"],
                    help="sparse device engine (see docs/TUNING.md)")
    ap.add_argument("--implicit", action="store_true",
                    help="binarize ratings to click events")
    ap.add_argument("--eval-recall", type=int, metavar="K", default=0,
                    help="hold out 1 item/user and report recall@K")
    ap.add_argument("--save", metavar="DIR",
                    help="write a serving bundle (Recommender.save)")
    ap.add_argument("--metrics", metavar="JSONL",
                    help="append per-check metrics records")
    ap.add_argument("--verbosity", type=int, default=1)
    args = ap.parse_args(argv)

    import os

    plat = os.environ.get("NMFTPU_PLATFORM")
    if plat:  # pin the backend (see examples/_common.py)
        os.environ["JAX_PLATFORMS"] = plat
        import jax

        try:
            jax.config.update("jax_platforms", plat)
        except Exception:
            pass

    import numpy as np

    import nmftpu
    from nmftpu.utils import JsonlLogger

    test_pairs = None
    train = None
    if args.data.endswith(".npy"):
        if args.eval_recall:
            raise SystemExit(
                "--eval-recall needs an interactions file (u.data / "
                "ratings.csv) for the per-user train/test split; a dense "
                ".npy has no interaction records to hold out"
            )
        data = np.load(args.data)
        print(f"dense matrix {data.shape}")
    else:
        from nmftpu.data import load_movielens, train_test_split_by_user

        inter = load_movielens(args.data, implicit=args.implicit)
        print(f"{inter.n_users} users x {inter.n_items} items, "
              f"{inter.matrix.nnz} interactions")
        if args.eval_recall:
            train, test_pairs = train_test_split_by_user(inter)
            data = train
            print(f"held out {len(test_pairs)} pairs for recall@"
                  f"{args.eval_recall}")
        else:
            data = inter.matrix

    logger = JsonlLogger(args.metrics).bind(cli=True) if args.metrics \
        else None
    res = nmftpu.nmf(
        data, args.rank,
        algorithm=args.algorithm, objective=args.objective,
        init=args.init, seed=args.seed,
        num_iterations=args.iters, num_runs=args.runs,
        threshold=args.threshold, threshold_type=args.threshold_type,
        alpha_confidence=args.alpha_confidence,
        **({"beta": args.beta} if args.beta is not None else {}),
        dtype=args.dtype,
        v_storage=args.v_storage,
        strategy=args.strategy,
        verbosity=args.verbosity,
        callback=logger.as_callback() if logger else None,
    )
    summary = {
        "frobenius_error": res.frobenius_error,
        "rmsd": res.rmsd,
        "iterations": res.num_iterations,
        "converged": res.converged,
        "elapsed_ms": round(res.elapsed_ms, 1),
    }
    if res.kl_error is not None:
        summary["kl_error"] = res.kl_error

    if test_pairs is not None and len(test_pairs):
        from nmftpu.retrieval import recall_at_k

        rec = recall_at_k(
            res.W, res.H, test_pairs, train=train, k=args.eval_recall
        )
        summary[f"recall@{args.eval_recall}"] = round(rec, 4)

    if args.save:
        from nmftpu.serving import Recommender

        Recommender(res.W, res.H, train=train).save(args.save)
        summary["saved"] = args.save

    print(json.dumps(summary))
    if logger:
        logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
