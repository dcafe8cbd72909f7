"""The recommended production setting for rating/count data: the whole
pipeline on int8 V storage (docs/TUNING.md §1–2).

V is held once as int8 + one symmetric scale — quarter the device
memory footprint, exact on ≤127-level grids — and the updates run a
bf16-dequantized contraction (dense Frobenius MU), int8 x int8 dots
(ALS family) or the scale-folded blockwise KL. The serving stage stores the item table
bf16 (halved footprint, f32-accumulated scores)."""

from _common import base_parser, load_or_synthesize


def main():
    ap = base_parser(__doc__)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--objective", default="frobenius",
                    choices=["frobenius", "kl"])
    args = ap.parse_args()
    import numpy as np

    import nmftpu
    from nmftpu.serving import Recommender

    inter = load_or_synthesize(
        args.data, 20_000, 8_000, 400_000, seed=4, implicit=False
    )
    res = nmftpu.nmf(
        inter.matrix, args.rank,
        objective=args.objective,
        v_storage="int8",              # quarter-footprint quantized V
        num_iterations=args.iters or 60,
        check_interval=10, seed=0,
    )
    line = (f"iterations={res.num_iterations} "
            f"frobenius_error={res.frobenius_error:.2f}")
    if res.kl_error is not None:
        line += f" kl_error={res.kl_error:.2f}"
    print(line + f" elapsed={res.elapsed_ms:.0f} ms")

    rec = Recommender(np.asarray(res.W), np.asarray(res.H),
                      train=inter.matrix, table_dtype="bfloat16")
    scores, items = rec.recommend([0, 1, 2], k=10)
    print(f"bf16-table serving: top-10 for user 0 = {items[0].tolist()}")


if __name__ == "__main__":
    main()
