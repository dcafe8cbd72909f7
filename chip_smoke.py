#!/usr/bin/env python
"""Smoke run of nmftpu's main paths on the GPU, checked against plain
float32 jax.numpy references computed at precision=HIGHEST.

    python chip_smoke.py           # one card: train, dense, serve, and
                                   # the tests marked `gpu`
    python chip_smoke.py --multi   # four cards: the sharded paths only

Every phase goes through the public entry points (`nmftpu.nmf`,
`prepare_sparse`/`compute_sparse`, `Recommender`, `compute_sharded`),
prints the implementation it selected, its compile and steady times and
the device's peak memory, each labelled with the card's name and power
limit, and compares its result with the reference at a stated
tolerance. Any failed phase or comparison stops the run with a non-zero
exit; the last line, a JSON object with `"ok": true`, is printed only
when every phase passed on a GPU. The run needs no network and uses one
process: the card's memory goes to that one JAX process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HALF_STARS = np.arange(1, 11, dtype=np.float32) / 2        # 0.5 .. 5.0
# ML-20M's rating histogram, 0.5 .. 5.0 stars, in percent (GroupLens's
# published counts, rounded)
HALF_STAR_SHARE = np.array([1.2, 3.4, 1.6, 7.2, 4.4, 21.2, 11.0, 26.5,
                            7.6, 15.0])


class SmokeFailure(RuntimeError):
    """A comparison outside its tolerance, or a phase that ran wrong."""


def card_line() -> str:
    """`name, power.limit` from nvidia-smi, run as a child that never
    touches JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"no nvidia-smi ({type(e).__name__})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


class Report:
    """Prints phase lines, each labelled with the card."""

    def __init__(self, card: str):
        self.card = card

    def log(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg} | {self.card}", flush=True)

    def check(self, phase: str, what: str, err: float, tol: float,
              why: str) -> None:
        ok = bool(np.isfinite(err)) and err <= tol
        self.log(phase, f"check {what}: error {err:.3e} vs tolerance "
                        f"{tol:.1e} ({why}): {'ok' if ok else 'FAILED'}")
        if not ok:
            raise SmokeFailure(f"{phase}: {what} error {err:.3e} > {tol}")

    def peak(self, phase: str) -> None:
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        self.log(phase, "peak_bytes_in_use "
                        f"{stats.get('peak_bytes_in_use', 'n/a')}")


def timed(fn):
    """(result, seconds) with the device work ended by
    block_until_ready (on the factors of a factorization result)."""
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready((out.W, out.H) if hasattr(out, "W") else out)
    return out, time.perf_counter() - t0


def first_and_steady(fn):
    """(result, compile seconds, steady seconds): the first call less
    the second is the compile time."""
    _, first = timed(fn)
    out, steady = timed(fn)
    return out, max(first - steady, 0.0), steady


def rel_fro(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ---------------------------------------------------------------------------
# train: sparse KL at ML-20M shape
# ---------------------------------------------------------------------------


def make_ratings(n, m, nnz, seed):
    """Exactly `nnz` distinct (user, item) pairs with power-law user and
    item activity (exponents 0.4 and 0.5, chosen so the busiest user and
    item hold about as many ratings as ML-20M's) and half-star ratings
    drawn from ML-20M's histogram. Returns a SparseCOO."""
    from nmftpu.sparse import SparseCOO

    rng = np.random.default_rng(seed)

    def draw(p, size):
        cdf = np.cumsum(p / p.sum())
        return np.minimum(np.searchsorted(cdf, rng.random(size)),
                          len(p) - 1)

    perm_u, perm_i = rng.permutation(n), rng.permutation(m)
    p_u = (1.0 + np.arange(n)) ** -0.4
    p_i = (1.0 + np.arange(m)) ** -0.5
    keys = np.zeros(0, np.int64)
    while keys.size < nnz:
        size = int((nnz - keys.size) * 1.2) + 1024
        new = perm_u[draw(p_u, size)].astype(np.int64) * m \
            + perm_i[draw(p_i, size)]
        keys = np.unique(np.concatenate([keys, new]))
    keys = np.sort(keys[rng.permutation(keys.size)[:nnz]])
    vals = HALF_STARS[draw(HALF_STAR_SHARE, nnz)]
    return SparseCOO(keys // m, keys % m, vals.astype(np.float32), (n, m))


def kl_mu_reference(V, W, H, iters, eps, panel):
    """`iters` Gauss–Seidel KL MU steps (W then H) on dense f32 V, every
    product at HIGHEST, in row panels so no (n, m) intermediate is
    built. V and W are row-padded with zeros to a panel multiple."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    hi = lax.Precision.HIGHEST
    npan = V.shape[0] // panel

    def run(V, W, H):
        def rows(x, p):
            return lax.dynamic_slice_in_dim(x, p * panel, panel, 0)

        def step(_, wh):
            W, H = wh
            h_sum = jnp.maximum(H.sum(axis=1), eps)

            def w_panel(p, Wn):
                Wp = rows(W, p)
                R = rows(V, p) / (jnp.dot(Wp, H, precision=hi) + eps)
                Wp = Wp * jnp.dot(R, H.T, precision=hi) / h_sum
                return lax.dynamic_update_slice_in_dim(Wn, Wp, p * panel,
                                                       0)

            W = lax.fori_loop(0, npan, w_panel, W)
            w_sum = jnp.maximum(W.sum(axis=0), eps)

            def h_panel(p, acc):
                Wp = rows(W, p)
                R = rows(V, p) / (jnp.dot(Wp, H, precision=hi) + eps)
                return acc + jnp.dot(Wp.T, R, precision=hi)

            numer = lax.fori_loop(0, npan, h_panel, jnp.zeros_like(H))
            return W, H * numer / w_sum[:, None]

        return lax.fori_loop(0, iters, step, (W, H))

    return jax.jit(run)(V, W, H)


def phase_train(rep, n=138_493, m=26_744, nnz=20_000_263, rank=64,
                iters=5, seed=0, cap=1000, panel=8192):
    import jax
    import jax.numpy as jnp

    import nmftpu
    from nmftpu.config import Initialization, NmfConfig, Objective

    ph = "train"
    t0 = time.perf_counter()
    sp = make_ratings(n, m, nnz, seed)
    rep.log(ph, f"ratings {n} x {m}, nnz {sp.nnz}, half-star grid, "
                f"made on the host in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed + 1)
    W0 = rng.uniform(0.1, 1.0, (n, rank)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (rank, m)).astype(np.float32)
    eps = NmfConfig(rank=rank).eps
    runs = {}
    for storage in ("float32", "int8"):
        cfg = NmfConfig(rank=rank, objective=Objective.KL,
                        init_method=Initialization.COPY_EXISTING,
                        num_iterations=iters, check_interval=iters,
                        v_storage=storage)
        plan, t_prep = timed(lambda: nmftpu.prepare_sparse(sp, cfg))
        res, comp, steady = first_and_steady(
            lambda: plan.run(W0=W0, H0=H0))
        rep.log(ph, f"v_storage={storage}: engine {plan.strategy}, "
                    f"prepare {t_prep:.3f} s, compile {comp:.3f} s, "
                    f"{steady / iters * 1e3:.3f} ms/iter (plan.run wall "
                    f"/ iterations), KL "
                    f"{res.kl_error:.6e}")
        runs[storage] = (np.asarray(res.W), np.asarray(res.H),
                         float(res.kl_error))
        del plan, res
    rep.peak(ph)

    npad = -(-n // panel) * panel
    Vd = jnp.zeros((npad, m), jnp.float32).at[
        jnp.asarray(sp.row), jnp.asarray(sp.col)].set(jnp.asarray(sp.data))
    Wp = jnp.zeros((npad, rank), jnp.float32).at[:n].set(W0)
    (Wr, Hr), t_ref = timed(
        lambda: kl_mu_reference(Vd, Wp, jnp.asarray(H0), iters, eps, panel))
    Wr = np.asarray(Wr[:n])
    Hr = np.asarray(Hr)
    rep.log(ph, f"reference: dense f32 V, KL MU at HIGHEST, {iters} "
                f"iterations in {t_ref:.3f} s")
    del Vd, Wp
    # bf16 operands of the densified contractions round W and H to 2^-9
    # relative; five multiplicative steps compound that to well under
    # 1% in norm.
    tol = 1e-2
    why = "bf16 contraction operands (2^-9) over 5 MU steps"
    for name, got, want in (("W", runs["float32"][0], Wr),
                            ("H", runs["float32"][1], Hr)):
        rep.check(ph, f"v_storage=float32 {name} (rel. Frobenius)",
                  rel_fro(got, want), tol, why)
    # int8 adds quantize_v's bound: each rating moves by at most
    # scale/2 = (5/127)/2, at most 3.9% of the smallest rating (0.5)
    tol8 = tol + 0.5 * (5.0 / 127.0) / 0.5
    why8 = why + " + quantize_v's scale/2 over the smallest rating"
    for name, got, want in (("W", runs["int8"][0], Wr),
                            ("H", runs["int8"][1], Hr)):
        rep.check(ph, f"v_storage=int8 {name} (rel. Frobenius)",
                  rel_fro(got, want), tol8, why8)

    # iterations to a threshold, at the library's precision and under
    # HIGHEST for every product that names none
    for label, ctx in (("library precision", None),
                       ("HIGHEST", "highest")):
        def fit():
            return nmftpu.nmf(
                sp, rank, objective="kullback-leibler", init="copy",
                W0=W0, H0=H0, num_iterations=cap, threshold=1e-5,
                threshold_type="rmsd", check_interval=10)

        if ctx is None:
            res, secs = timed(fit)
        else:
            with jax.default_matmul_precision(ctx):
                res, secs = timed(fit)
        rep.log(ph, f"threshold 1e-5 (rmsd delta) under {label}: "
                    f"{res.num_iterations} iterations, converged "
                    f"{bool(res.converged)}, {secs:.3f} s with compile")
        if not np.isfinite(res.kl_error):
            raise SmokeFailure(f"{ph}: threshold run under {label} is "
                               "not finite")
    rep.peak(ph)


# ---------------------------------------------------------------------------
# dense: 4096 x 4096 at rank 256
# ---------------------------------------------------------------------------


def dense_reference(name, V, W, H, iters):
    """The plain update rules of linalg/dense.py at HIGHEST."""
    import jax
    import jax.numpy as jnp

    from nmftpu.linalg import dense as D

    def hals(V, W, H):
        W = D._hals_half_sweep(V @ H.T, H @ H.T, W)
        return W, D._hals_half_sweep(V.T @ W, W.T @ W, H.T).T

    def mu(V, W, H):
        return D.mu_update_frobenius(V, W, H)

    def als(V, W, H):
        return D.als_update(V, W, H)

    step = {"hals": hals, "mu": mu, "als": als}[name]
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda V, W, H: jax.lax.fori_loop(
            0, iters, lambda _, c: step(V, *c), (W, H)))(
                V, jnp.asarray(W), jnp.asarray(H))


def phase_dense(rep, n=4096, rank=256, iters=5, seed=1):
    import jax.numpy as jnp

    import nmftpu
    from nmftpu.linalg.dense import HIGHEST

    ph = "dense"
    rng = np.random.default_rng(seed)
    V = (rng.uniform(0, 1, (n, rank)) @ rng.uniform(0, 1, (rank, n))
         / rank + 0.1 * rng.uniform(0, 1, (n, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, (n, rank)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (rank, n)).astype(np.float32)
    Vj = jnp.asarray(V)
    cases = (
        # (label, nmf kwargs, reference, tolerance, why)
        ("hals", dict(algorithm="hals"), "hals", 1e-2,
         "TF32 numerators (2^-11 operands), sequential sweeps at "
         "HIGHEST, 5 iterations"),
        ("mu v_storage=int8", dict(v_storage="int8"), "mu", 2e-2,
         "bf16 contraction operands (2^-9) + quantize_v's scale/2"),
        ("als", dict(algorithm="als"), "als", 1e-3,
         "every contraction at HIGHEST; the solves amplify f32 "
         "roundoff by cond(Gram)"),
    )
    for label, kw, ref_name, tol, why in cases:
        def fit():
            return nmftpu.nmf(Vj, rank, init="copy", W0=W0, H0=H0,
                              num_iterations=iters,
                              check_interval=iters, **kw)

        res, comp, steady = first_and_steady(fit)
        Wr, Hr = dense_reference(ref_name, Vj, W0, H0, iters)
        got = jnp.matmul(res.W, res.H, precision=HIGHEST)
        want = jnp.matmul(Wr, Hr, precision=HIGHEST)
        rep.log(ph, f"{label}: {n} x {n}, r={rank}, compile "
                    f"{comp:.3f} s, {steady / iters * 1e3:.3f} ms/iter")
        rep.check(ph, f"{label} WH (rel. Frobenius)", rel_fro(got, want),
                  tol, why)
    rep.peak(ph)


# ---------------------------------------------------------------------------
# serve: top-100 over 10.49M items
# ---------------------------------------------------------------------------


def reference_topk(Wq, H, seen, k, block):
    """Blocked exact scan at HIGHEST with seen items masked, then
    lax.top_k: (scores, ids) of the exact top-k per query."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    b = Wq.shape[0]
    m = H.shape[1]

    @jax.jit
    def blk(Wq, Hb, start, seen):
        s = jnp.dot(Wq, Hb.astype(jnp.float32),
                    precision=lax.Precision.HIGHEST)
        loc = seen - start
        ok = (seen >= 0) & (loc >= 0) & (loc < Hb.shape[1])
        s = s.at[jnp.arange(b)[:, None], jnp.where(ok, loc, Hb.shape[1])
                 ].set(-jnp.inf, mode="drop")
        top, pos = lax.top_k(s, k)
        return top, pos + start

    parts = [blk(Wq, H[:, s:s + block], s, seen) for s in range(0, m, block)]
    cs = jnp.concatenate([p[0] for p in parts], axis=1)
    ci = jnp.concatenate([p[1] for p in parts], axis=1)
    top, pos = lax.top_k(cs, k)
    return np.asarray(top), np.asarray(jnp.take_along_axis(ci, pos, 1))


def exact_scores(Wq, H, ids):
    """f32 scores of (query, id) pairs at HIGHEST, from the table values
    the server holds."""
    import jax.numpy as jnp

    cols = jnp.take(H, jnp.asarray(ids), axis=1).astype(jnp.float32)
    return np.asarray(jnp.einsum("br,rbk->bk", jnp.asarray(Wq), cols,
                                 precision="highest"))


def topk_agreement(Wq, H, ids, seen, ref_s, tau):
    """(worst shortfall below the reference k-th score in units of the
    tie tolerance, recall@k counting items within tau of the k-th
    score as hits). Raises on duplicate or excluded ids."""
    k = ids.shape[1]
    for q in range(ids.shape[0]):
        if len(set(ids[q].tolist())) != k:
            raise SmokeFailure(f"row {q} returned duplicate ids")
        if set(ids[q].tolist()) & set(seen[q][seen[q] >= 0].tolist()):
            raise SmokeFailure(f"row {q} returned a seen item")
    got = exact_scores(Wq, H, ids)
    kth = ref_s[:, -1:]
    short = np.max((kth - got) / tau)
    recall = float(np.mean(got >= kth - tau))
    return float(short), recall


def scan_kernel_vs_plain(rep, ph, dtype, Wq, Ht, slots=4096):
    """The reservoir scan as the Triton kernel compiled for the card and
    as the plain XLA form, at the table's full width: the same
    candidates (ids equal, scores to f32 summation order), and both
    times."""
    import jax
    import jax.numpy as jnp

    from nmftpu.kernels import mips_reservoir as M

    m = Ht.shape[1]
    q_block, slot_block = 128, 64
    bp = -(-Wq.shape[0] // q_block) * q_block
    Wqp = jnp.pad(Wq, ((0, bp - Wq.shape[0]), (0, 0)))
    # the Pallas interpreter only in the CPU rehearsal of this phase
    interpret = jax.devices()[0].platform != "gpu"
    kern = jax.jit(lambda a, h: M._scan_kernel(a, h, m, slots, q_block,
                                               slot_block, interpret))
    plain = jax.jit(lambda a, h: M._scan_plain(a, h, m, slots))
    (ks, ki), kc, kt = first_and_steady(lambda: kern(Wqp, Ht))
    (ps, pi), pc, pt = first_and_steady(lambda: plain(Wq, Ht))
    b = Wq.shape[0]
    rep.log(ph, f"{dtype} reservoir scan at b={b}, m={m}, slots={slots}: "
                f"Triton kernel {kt * 1e3:.3f} ms (compile {kc:.3f} s), "
                f"plain XLA {pt * 1e3:.3f} ms (compile {pc:.3f} s)")
    mism = int(jnp.sum(ki[:b] != pi))
    rep.check(ph, f"{dtype} kernel vs plain scan: differing ids", mism, 0,
              "the same top-2-per-slot semantics")
    rep.check(ph, f"{dtype} kernel vs plain scan: max score difference",
              float(jnp.max(jnp.abs(ks[:b] - ps))), 1e-3,
              "bf16 operands, f32 accumulation in another order")


def phase_serve(rep, m=10_485_760, rank=256, b=512, k=100, seen_per=100,
                n_users=1024, seed=2, ref_block=1 << 20):
    import jax
    import jax.numpy as jnp

    from nmftpu import serving
    from nmftpu.sparse import SparseCSR

    ph = "serve"
    rng = np.random.default_rng(seed)
    # nonnegative factors with a spread of item popularity, like a
    # trained NMF table
    key = jax.random.PRNGKey(seed)
    H = jax.random.exponential(key, (rank, m), jnp.float32) * \
        jax.random.uniform(jax.random.fold_in(key, 1), (1, m), jnp.float32)
    W = rng.exponential(1.0, (n_users, rank)).astype(np.float32)
    seen_cnt = rng.integers(seen_per // 2, 3 * seen_per // 2, n_users)
    indptr = np.concatenate([[0], np.cumsum(seen_cnt)])
    indices = np.concatenate([np.sort(rng.choice(m, c, replace=False))
                              for c in seen_cnt])
    train = SparseCSR(indptr, indices,
                      np.ones(indices.size, np.float32), (n_users, m))
    users = np.arange(b)
    S = int(seen_cnt[:b].max())
    seen = np.full((b, S), -1, np.int32)
    for q in range(b):
        seen[q, :seen_cnt[q]] = indices[indptr[q]:indptr[q + 1]]
    H_host = np.asarray(H)
    del H
    rep.log(ph, f"table m={m}, r={rank}; batches b={b}, k={k}, ~{seen_per}"
                f" seen items per user excluded; _SERVE_BLOCK="
                f"{serving._SERVE_BLOCK}")
    for dtype in ("bfloat16", "float32"):
        # the reference reads the table values the server holds
        Ht = jnp.asarray(H_host, jnp.dtype(dtype))
        Wq = W[users]
        (ref_s, ref_i), t_ref = timed(
            lambda: reference_topk(jnp.asarray(Wq), Ht, jnp.asarray(seen),
                                   k, ref_block))
        # tie tolerance: four units of the scan's rounding relative to
        # the k-th score, which is sum |q_i h_i| for these nonnegative
        # factors (bf16 queries: 2^-8; f32 at HIGHEST: 256-term sums,
        # 2^-16)
        u = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -16
        tau = 4 * u * np.abs(ref_s[:, -1:])
        rep.log(ph, f"{dtype}: reference scan {t_ref:.3f} s")
        scan_kernel_vs_plain(rep, ph, dtype, jnp.asarray(Wq), Ht)
        del Ht
        for method in ("exact", "approx", "reservoir"):
            rec = serving.Recommender(W, H_host, train=train,
                                      method=method, table_dtype=dtype)
            (s, i), comp, steady = first_and_steady(
                lambda: rec.recommend(users, k=k))
            impl = method
            if method == "reservoir":
                from nmftpu import backend
                from nmftpu.kernels.mips_reservoir import kernel_fits

                impl = ("Triton kernel" if backend.use_kernel(
                    "mips_reservoir") and kernel_fits(
                        rank, rec.reservoir_slots) else "plain XLA")
            short, recall = topk_agreement(Wq, rec.H, i, seen, ref_s, tau)
            rep.log(ph, f"{dtype} {method} ({impl}): compile {comp:.3f} s"
                        f", {steady * 1e3:.3f} ms/batch, "
                        f"{b / steady:.1f} q/s, recall@{k} (ties count) "
                        f"{recall:.5f}")
            if method == "exact":
                rep.check(ph, f"{dtype} exact vs reference (k-th score "
                              "shortfall / tie tolerance)", short, 1.0,
                          "up to ties")
            else:
                floor = 0.95 if method == "approx" else 0.99
                rep.check(ph, f"{dtype} {method} recall@{k} shortfall",
                          1.0 - recall, 1.0 - floor,
                          f"floor {floor}: approx's per-block recall "
                          "target 0.95; reservoir's C(k,3)/slots^2 "
                          "miss rate")
            if method == "reservoir":
                (cs, ci, cert), comp, steady = first_and_steady(
                    lambda: rec.recommend_certified(users, k=k,
                                                    fallback="exact"))
                short, _ = topk_agreement(Wq, rec.H, ci, seen, ref_s, tau)
                rep.log(ph, f"{dtype} recommend_certified(fallback="
                            f"'exact'): compile {comp:.3f} s, "
                            f"{steady * 1e3:.3f} ms/batch, "
                            f"{b / steady:.1f} q/s, pass-1 certified "
                            f"{int(np.sum(cert))}/{b}")
                rep.check(ph, f"{dtype} certified rows vs reference "
                              "(k-th score shortfall / tie tolerance)",
                          short, 1.0, "up to ties")
            del rec
        rep.peak(ph)


# ---------------------------------------------------------------------------
# multi: the sharded paths on four cards
# ---------------------------------------------------------------------------


def describe_shards(arr) -> str:
    return ", ".join(f"{s.device}:{s.index}" for s in arr.addressable_shards)


def phase_multi(rep, n_per=200_000, m_per=100_000, nnz_per=10_000_000,
                rank=256, iters=5, seed=3, serve_m=10_485_760, b=512,
                k=100):
    import jax
    import jax.numpy as jnp

    from nmftpu import serving
    from nmftpu.config import Initialization, NmfConfig
    from nmftpu.data import synthetic_powerlaw_sparse
    from nmftpu.parallel import (compute_sharded, factor_shardings,
                                 make_grid_mesh)

    ph = "multi"
    devs = jax.devices()
    if len(devs) < 4:
        raise SmokeFailure(f"--multi needs 4 devices, JAX has {len(devs)}")
    devs = devs[:4]
    n, m = 2 * n_per, 2 * m_per
    sp, t_gen = timed(lambda: synthetic_powerlaw_sparse(
        n, m, nnz=4 * nnz_per, seed=seed))
    rep.log(ph, f"power-law matrix {n} x {m}, nnz {sp.nnz} (made in "
                f"{t_gen:.2f} s), rank {rank}")
    rng = np.random.default_rng(seed)
    W0 = rng.uniform(0.1, 1.0, (n, rank)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (rank, m)).astype(np.float32)
    cfg = NmfConfig(rank=rank, num_iterations=iters, check_interval=iters,
                    init_method=Initialization.COPY_EXISTING)
    one = make_grid_mesh((1, 1), devices=devs[:1])
    for engine, shape in (("ell", (2, 2)), ("ring", (1, 4))):
        mesh = make_grid_mesh(shape, devices=devs)
        sh = factor_shardings(mesh)
        for name, arr in (("W", W0), ("H", H0)):
            placed = jax.device_put(arr, sh[name])
            shards = placed.addressable_shards
            rep.log(ph, f"{engine} mesh {shape} over "
                        f"{mesh.devices.tolist()}: {name} shards "
                        f"{describe_shards(placed)}")
            if len({s.device for s in shards}) != len(shards):
                raise SmokeFailure(f"two {name} shards share a device")
            del placed
        res, comp, steady = first_and_steady(lambda: compute_sharded(
            sp, cfg, mesh=mesh, engine=engine, W0=W0, H0=H0))
        ref, comp1, steady1 = first_and_steady(lambda: compute_sharded(
            sp, cfg, mesh=one, engine=engine, W0=W0, H0=H0))
        rep.log(ph, f"{engine} {shape}: compile {comp:.3f} s, "
                    f"{steady / iters * 1e3:.3f} ms/iter (wall, with "
                    f"ingest); one card: {steady1 / iters * 1e3:.3f} "
                    "ms/iter")
        for name, got, want in (("W", res.W, ref.W), ("H", res.H, ref.H)):
            rep.check(ph, f"{engine} {shape} {name} vs one card "
                          "(rel. Frobenius)", rel_fro(got, want), 1e-3,
                      "same f32 math, psum summation order")
        del res, ref

    # sharded serving over an item-sharded table
    key = jax.random.PRNGKey(seed)
    H = np.asarray(jax.random.exponential(key, (rank, serve_m),
                                          jnp.float32))
    W = rng.exponential(1.0, (b, rank)).astype(np.float32)
    users = np.arange(b)
    mesh = make_grid_mesh((1, 4), devices=devs)
    single = serving.Recommender(W, H, method="exact",
                                 table_dtype="bfloat16")
    (s1, i1), _, t1 = first_and_steady(
        lambda: single.recommend(users, k=k, exclude_seen=False))
    del single
    for method in ("exact", "reservoir"):
        rec = serving.Recommender(W, H, mesh=mesh, method=method,
                                  table_dtype="bfloat16")
        rep.log(ph, f"serving table shards: {describe_shards(rec.H)}")
        (s, i), comp, steady = first_and_steady(
            lambda: rec.recommend(users, k=k, exclude_seen=False))
        got = exact_scores(W, rec.H, i)
        kth = exact_scores(W, rec.H, i1[:, -1:])
        tau = 4 * 2.0 ** -8 * np.abs(kth)     # bf16 queries; H >= 0
        recall = float(np.mean(got >= kth - tau))
        rep.log(ph, f"sharded {method} over 4 cards: compile {comp:.3f} "
                    f"s, {steady * 1e3:.3f} ms/batch, {b / steady:.1f} "
                    f"q/s (one card exact: {b / t1:.1f} q/s); recall@{k}"
                    f" vs one-card exact {recall:.5f}")
        floor = 1.0 if method == "exact" else 0.99
        rep.check(ph, f"sharded {method} recall@{k} shortfall vs one card",
                  1.0 - recall, 1.0 - floor,
                  "exact up to ties" if method == "exact"
                  else "per-shard reservoir miss rate")
        del rec
    rep.peak(ph)


# ---------------------------------------------------------------------------


def run_gpu_tests() -> None:
    """The tests marked `gpu`, in this process (a second JAX process
    could not get the card's memory)."""
    import pytest

    code = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                        "-rs", os.path.join(ROOT, "tests", "test_gpu.py")])
    if code != 0:
        raise SmokeFailure(f"the gpu-marked tests failed (pytest exit "
                           f"{code})")


def require_gpu(devices) -> None:
    """Refuse to report anything unless JAX runs on a GPU."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX's device is "
                         f"{plat}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    card = card_line()
    print(f"card: {card}", flush=True)

    import jax

    from nmftpu import backend

    cache = backend.use_compile_cache()
    devices = jax.devices()
    require_gpu(devices)
    print(f"jax {jax.__version__}; compile cache {cache}; devices "
          f"{len(devices)} x {devices[0].device_kind}", flush=True)
    rep = Report(card)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(rep)
    else:
        phase_train(rep)
        phase_dense(rep)
        phase_serve(rep)
        run_gpu_tests()
    print(f"smoke: all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
