"""Config #5: retrieval serving — the learned W/H factors as embedding
tables scored by top-k MIPS, evaluated with recall@100 on held-out
interactions (leave-latest-out per user)."""

from _common import base_parser, load_or_synthesize


def main():
    ap = base_parser(__doc__)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--k", type=int, default=100)
    args = ap.parse_args()
    import nmftpu
    from nmftpu.data import train_test_split_by_user
    from nmftpu.retrieval import recall_at_k

    inter = load_or_synthesize(args.data, 4000, 2000, 120_000, seed=3)
    train, test_pairs = train_test_split_by_user(
        inter, holdout_per_user=1, seed=0
    )
    print(f"train nnz={train.nnz}, held-out pairs={len(test_pairs)}")

    res = nmftpu.nmf(
        train, args.rank,
        algorithm="mu", objective="frobenius",
        alpha_confidence=10.0,
        num_iterations=args.iters or 60, check_interval=20, seed=0,
    )
    rec = recall_at_k(
        res.W, res.H, test_pairs, train=train, k=args.k,
        batch_users=512,
    )
    print(f"recall@{args.k} = {rec:.4f} "
          f"(frobenius_error={res.frobenius_error:.2f})")

    # production serving: method="reservoir" runs the top-2-per-slot
    # reservoir scan (the Triton kernel on the GPU, plain XLA on the
    # CPU). Exclusion of each user's training items is exact;
    # recommend_certified additionally proves rows exact up to kth-score
    # ties.
    from nmftpu.serving import Recommender

    method = "reservoir"
    server = Recommender(res.W, res.H, train=train, method=method)
    s, i = server.recommend([0, 1, 2], k=10)
    # fallback="exact": uncertified rows are re-scanned exact in the
    # same call, so EVERY row is the exact top-k; `cert` still reports
    # the pass-1 rate.
    s2, i2, cert = server.recommend_certified([0, 1, 2], k=10,
                                              fallback="exact")
    print(f"serving[{method}]: top-10 for 3 users, all-exact "
          f"(pass-1 certified {int(cert.sum())}/3)")


if __name__ == "__main__":
    main()
