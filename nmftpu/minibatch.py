"""Online / mini-batch NMF (the `sklearn.decomposition.MiniBatchNMF`
algorithm of Fevotte & Idier 2011 + Lefevre, Bach & Fevotte 2011): W is
updated per mini-batch of rows, H through exponentially-forgotten
sufficient-statistic accumulators A/B, so the model fits row streams and
datasets far beyond device memory.

Shape of the design: every mini-batch step is a handful of
(b, m) x (m, r) GEMMs at panel size, jitted once per batch
shape and replayed. V itself is never required on device: `fit` slices
row panels from the host array (or any indexable source), and
`OnlineNMF.partial_fit` consumes an arbitrary stream of row batches, so
the resident state is just H/A/B (3 x r x m) and the current panel. For
V small enough to live in HBM, the same step functions run inside a
jitted epoch scan (one dispatch per epoch instead of per batch).

Numerics mirror sklearn's `_multiplicative_update_w/_h` guard-for-guard
(EPSILON clamps, the gamma MM exponent, the beta<1 / beta<=1 factor
stabilizations), so float64 runs match MiniBatchNMF to roundoff — see
tests/test_minibatch.py. Reference behavior: SURVEY.md C3 (MU family)
extended to the online setting; this has no reference-library
counterpart (nmfgpu is batch-only).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from nmftpu import backend

# The sklearn-exact MU primitives and constants are shared with the
# batch engines (single source — see linalg/dense.py): EPSILON is
# sklearn's float32-eps guard threshold; _STAB_EPS its factor-zeroing
# floor (W at beta<1, H at beta<=1 for the online variant).
from nmftpu.linalg.dense import (  # noqa: E402
    EPSILON,
    _STAB_EPS,
    beta_gamma,
    beta_h_terms,
    beta_w_step,
)


def w_mu_step(Xb, W, H, beta=2.0, l1_w=0.0, l2_w=0.0, gamma=1.0):
    """One multiplicative W update on a row batch (sklearn's
    _multiplicative_update_w; shared implementation with the batch
    beta engine)."""
    return beta_w_step(Xb, W, H, beta, l1_w=l1_w, l2_w=l2_w,
                       gamma=gamma)


def h_online_step(Xb, W, H, A, B, rho, beta=2.0, l1_h=0.0, l2_h=0.0,
                  gamma=1.0):
    """Online H update: fold this batch's MU numerator/denominator into
    the forgetting accumulators (A, B) and re-solve H = (A/B)^gamma
    (sklearn's _multiplicative_update_h with A/B/rho). Returns
    (H, A, B)."""
    numer, denom = beta_h_terms(Xb, W, H, beta)
    if l1_h > 0.0:
        denom = denom + l1_h
    if l2_h > 0.0:
        denom = denom + l2_h * H
    denom = jnp.where(denom == 0.0, EPSILON, denom)
    Hg = H ** (1.0 / gamma) if gamma != 1.0 else H
    A = rho * A + numer * Hg
    B = rho * B + denom
    Hn = A / B
    if gamma != 1.0:
        Hn = Hn ** gamma
    if beta <= 1.0:
        Hn = jnp.where(Hn < _STAB_EPS, 0.0, Hn)
    return Hn, A, B


@functools.partial(
    jax.jit,
    static_argnames=("beta", "l1_w", "l2_w", "gamma", "max_iter", "tol"),
)
def solve_w(Xb, H, beta=2.0, l1_w=0.0, l2_w=0.0, gamma=1.0,
            max_iter=200, tol=1e-4, mean_v=None):
    """Solve for a batch's W with H frozen (sklearn's _solve_W: the
    transform path and the fresh-restarts path), from the flat
    sqrt(mean/r) start, stopping on relative W change <= tol.
    mean_v: optional precomputed global mean of the FULL matrix for
    the flat start (the streamed final solve passes it so every panel
    starts exactly where sklearn's full-matrix solve would)."""
    r = H.shape[0]
    avg = jnp.sqrt((jnp.mean(Xb) if mean_v is None else mean_v) / r)
    W0 = jnp.full((Xb.shape[0], r), avg, dtype=Xb.dtype)

    def body(carry):
        W, _, it, _ = carry
        Wn = w_mu_step(Xb, W, H, beta, l1_w, l2_w, gamma)
        diff = jnp.linalg.norm(Wn - W) / jnp.maximum(
            jnp.linalg.norm(Wn), EPSILON
        )
        return Wn, W, it + 1, diff

    def cond(carry):
        _, _, it, diff = carry
        keep = it < max_iter
        if tol > 0:
            keep &= diff > tol
        return keep

    W, _, _, _ = jax.lax.while_loop(
        cond, body, (W0, W0, jnp.asarray(0, jnp.int32),
                     jnp.asarray(jnp.inf, Xb.dtype))
    )
    return W


@functools.partial(
    jax.jit,
    static_argnames=(
        "beta", "l1_w", "l2_w", "l1_h", "l2_h", "gamma", "fresh",
        "fresh_max_iter", "fresh_tol", "with_cost",
    ),
)
def minibatch_step(Xb, W, H, A, B, rho, beta=2.0, l1_w=0.0, l2_w=0.0,
                   l1_h=0.0, l2_h=0.0, gamma=1.0, fresh=False,
                   fresh_max_iter=30, fresh_tol=0.0, with_cost=False):
    """One full mini-batch step (sklearn's _minibatch_step with
    update_H=True): W step (warm single MU step, or a fresh solve),
    beta<1 stabilization, online H/A/B update. Returns
    (W, H, A, B, cost) — cost is the per-sample regularized batch
    divergence when with_cost, else 0."""
    if fresh or W is None:
        W = solve_w(Xb, H, beta, l1_w, l2_w, gamma,
                    max_iter=fresh_max_iter, tol=fresh_tol)
    else:
        W = w_mu_step(Xb, W, H, beta, l1_w, l2_w, gamma)
    if beta < 1.0:
        W = jnp.where(W < _STAB_EPS, 0.0, W)
    if with_cost:
        from nmftpu.linalg import dense as D

        if beta == 2.0:
            cost = 0.5 * D.frobenius_error_sq(Xb, W, H)
        elif beta == 1.0:
            cost = D.kl_error(Xb, W, H)
        else:
            cost = D.beta_divergence(Xb, W, H, beta)
        cost = (
            cost + l1_w * jnp.sum(W) + l1_h * jnp.sum(H)
            + l2_w * jnp.sum(W * W) + l2_h * jnp.sum(H * H)
        ) / Xb.shape[0]
    else:
        cost = jnp.asarray(0.0, Xb.dtype)
    H, A, B = h_online_step(Xb, W, H, A, B, rho, beta, l1_h, l2_h, gamma)
    return W, H, A, B, cost


@functools.partial(
    jax.jit,
    static_argnames=(
        "batch_size", "beta", "l1_w", "l2_w", "l1_h_full", "l2_h_full",
        "l1_h_tail", "l2_h_tail", "gamma", "fresh", "fresh_max_iter",
        "fresh_tol",
    ),
)
def epoch_fused(V, W, H, A, B, rho, *, batch_size, beta=2.0, l1_w=0.0,
                l2_w=0.0, l1_h_full=0.0, l2_h_full=0.0, l1_h_tail=0.0,
                l2_h_tail=0.0, gamma=1.0, fresh=False,
                fresh_max_iter=30, fresh_tol=0.0):
    """One full epoch of mini-batch steps as a single compiled program:
    a fori_loop over batch panels (dynamic_slice row windows, never a
    second V-sized buffer) plus an unrolled tail batch. Bit-identical
    to the host-per-batch loop (same step function, same order); the
    win is ONE dispatch per epoch — the host loop pays a dispatch and
    a host round trip per batch, which can dwarf the panel GEMMs.
    The tail batch carries its own H-regularization scale (sklearn
    scales H penalties by the batch's row count)."""
    import jax.lax as lax

    n = V.shape[0]
    nb, tail = divmod(n, batch_size)

    def one(Xb, Wb, H, A, B, l1_h, l2_h):
        return minibatch_step(
            Xb, (None if fresh else Wb), H, A, B, rho, beta=beta,
            l1_w=l1_w, l2_w=l2_w, l1_h=l1_h, l2_h=l2_h, gamma=gamma,
            fresh=fresh, fresh_max_iter=fresh_max_iter,
            fresh_tol=fresh_tol,
        )

    def body(i, carry):
        W, H, A, B = carry
        lo = i * batch_size
        Xb = lax.dynamic_slice_in_dim(V, lo, batch_size, 0)
        Wb = lax.dynamic_slice_in_dim(W, lo, batch_size, 0)
        Wb, H, A, B, _ = one(Xb, Wb, H, A, B, l1_h_full, l2_h_full)
        if not fresh:
            W = lax.dynamic_update_slice_in_dim(W, Wb, lo, 0)
        return W, H, A, B

    carry = (W, H, A, B)
    if nb:  # fori_loop(0, 0) still traces its body
        carry = lax.fori_loop(0, nb, body, carry)
    if tail:
        W, H, A, B = carry
        lo = nb * batch_size
        Xb = lax.dynamic_slice_in_dim(V, lo, tail, 0)
        Wb = lax.dynamic_slice_in_dim(W, lo, tail, 0)
        Wb, H, A, B, _ = one(Xb, Wb, H, A, B, l1_h_tail, l2_h_tail)
        if not fresh:
            W = lax.dynamic_update_slice_in_dim(W, Wb, lo, 0)
        carry = (W, H, A, B)
    return carry


def divergence_blocked(V, W, H, beta, batch=1024, dtype=jnp.float32):
    """D_beta(V || WH) summed over row panels (the divergence is
    row-additive for every beta), so V streams through batch-sized
    panels exactly like the fit loop — used for reconstruction_err_
    without materializing V or WH."""
    from nmftpu.linalg import dense as D

    n = V.shape[0]
    W = jnp.asarray(W, dtype)
    H = jnp.asarray(H, dtype)
    total = 0.0
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        Xb = jnp.asarray(V[lo:hi], dtype)
        Wb = W[lo:hi]
        if beta == 2.0:
            d = 0.5 * D.frobenius_error_sq(Xb, Wb, H)
        elif beta == 1.0:
            d = D.kl_error(Xb, Wb, H)
        else:
            d = D.beta_divergence(Xb, Wb, H, beta)
        total += float(d)
    return total


class OnlineNMF:
    """Streaming NMF: feed row batches in any order, read H at any time.

    The device-resident state is only (H, A, B) — three (r, m) arrays —
    so the item axis can be large and the row stream unbounded. Each
    `partial_fit(Xb)` runs one mini-batch step (fresh W solve, as
    sklearn's partial_fit); `transform(X)` solves W for new rows with H
    frozen.

    Parameters follow NmfConfig naming where they overlap; `beta` is the
    divergence exponent (2 = Frobenius, 1 = KL, 0 = Itakura-Saito, any
    float). alpha_w/alpha_h/l1_ratio carry sklearn's scaled-penalty
    semantics (W penalties scale by n_features, H penalties by the
    batch's row count).
    """

    def __init__(self, rank, *, beta=2.0, batch_size=1024,
                 forget_factor=0.7, n_rows_hint=None, alpha_w=0.0,
                 alpha_h="same", l1_ratio=0.0, fresh_max_iter=30,
                 transform_max_iter=200, transform_tol=1e-4,
                 dtype=jnp.float32, seed=0, mesh=None):
        self.rank = int(rank)
        self.beta = float(beta)
        self.gamma = beta_gamma(self.beta)
        self.batch_size = int(batch_size)
        self.forget_factor = float(forget_factor)
        # rho = forget_factor ** (batch_size / n_rows): with no known
        # total row count (a true stream), default to one batch per
        # "dataset" i.e. rho = forget_factor itself.
        n_hint = n_rows_hint if n_rows_hint else batch_size
        self.rho = self.forget_factor ** (self.batch_size / float(n_hint))
        self.alpha_w = float(alpha_w)
        self.alpha_h = (
            self.alpha_w if alpha_h == "same" else float(alpha_h)
        )
        self.l1_ratio = float(l1_ratio)
        self.fresh_max_iter = int(fresh_max_iter)
        self.transform_max_iter = int(transform_max_iter)
        self.transform_tol = float(transform_tol)
        self.dtype = dtype
        self.seed = int(seed)
        # mesh: shard the ITEM axis of H/A/B (and each batch's columns)
        # over every device of the given jax.sharding.Mesh — the steps
        # are plain GEMMs, so GSPMD inserts the psum pattern and the
        # streaming state scales past one chip's HBM. m must divide by
        # the device count.
        self._shardings = (
            _flat_item_shardings(mesh) if mesh is not None else None
        )
        self.H = None
        self._A = None
        self._B = None
        self.n_steps = 0

    def _regs(self, batch_rows, n_features):
        l1_w = n_features * self.alpha_w * self.l1_ratio
        l2_w = n_features * self.alpha_w * (1.0 - self.l1_ratio)
        l1_h = batch_rows * self.alpha_h * self.l1_ratio
        l2_h = batch_rows * self.alpha_h * (1.0 - self.l1_ratio)
        return l1_w, l2_w, l1_h, l2_h

    def _ensure_state(self, Xb, H0=None):
        if self.H is None:
            m = Xb.shape[1]
            if H0 is not None:
                self.H = jnp.asarray(H0, self.dtype)
            elif self.rank <= min(Xb.shape):
                # sklearn partial_fit's first-call default: NNDSVDA
                # seeded from the first batch — a near-subspace start
                # that converges far faster than a random H
                from nmftpu.init.nndsvd import nndsvd_init

                _, H0n = nndsvd_init(np.asarray(Xb), self.rank,
                                     variant="nndsvda", seed=self.seed)
                self.H = jnp.asarray(H0n, self.dtype)
            else:
                # overcomplete rank: mean-scaled positive random start
                key = jax.random.PRNGKey(self.seed)
                avg = float(np.sqrt(float(jnp.mean(Xb)) / self.rank))
                self.H = avg * jnp.abs(
                    jax.random.normal(key, (self.rank, m), self.dtype)
                )
            if self._shardings is not None:
                self.H = jax.device_put(self.H, self._shardings["H"])
            self._A = self.H
            self._B = jnp.ones_like(self.H)

    def _place(self, Xb):
        if self._shardings is not None:
            return jax.device_put(Xb, self._shardings["X"])
        return Xb

    def save(self, path):
        """Persist the full streaming state (H, A, B, step count,
        hyperparameters) so a stream can resume after a crash or
        redeploy — orbax when available (handles mesh-sharded arrays
        natively), .npz fallback. Mesh placement is NOT persisted;
        pass mesh= to `OnlineNMF.load` to re-shard on restore."""
        import json
        import os

        if self.H is None:
            raise ValueError("nothing to save: no data seen yet")
        path = os.path.abspath(path)
        meta = {
            "n_steps": self.n_steps,
            "rank": self.rank,
            "beta": self.beta,
            "batch_size": self.batch_size,
            "forget_factor": self.forget_factor,
            "rho": self.rho,
            "alpha_w": self.alpha_w,
            "alpha_h": self.alpha_h,
            "l1_ratio": self.l1_ratio,
            "fresh_max_iter": self.fresh_max_iter,
            "transform_max_iter": self.transform_max_iter,
            "transform_tol": self.transform_tol,
            "seed": self.seed,
            "dtype": jnp.dtype(self.dtype).name,
        }
        from nmftpu import checkpoint as CK

        state = {"H": self.H, "A": self._A, "B": self._B}
        if CK._HAS_ORBAX:
            ckptr = CK.ocp.StandardCheckpointer()
            ckptr.save(os.path.join(path, "online_state"), state,
                       force=True)
            ckptr.wait_until_finished()
        else:  # pragma: no cover
            os.makedirs(path, exist_ok=True)
            np.savez(os.path.join(path, "online_state.npz"),
                     **{k: np.asarray(v) for k, v in state.items()})
        with open(os.path.join(path, "online_meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path, mesh=None):
        """Restore a saved stream state; continue with partial_fit as
        if never interrupted. mesh= re-shards H/A/B on the new mesh."""
        import json
        import os

        path = os.path.abspath(path)
        with open(os.path.join(path, "online_meta.json")) as f:
            meta = json.load(f)
        n_steps = meta.pop("n_steps")
        rho = meta.pop("rho")
        dtype = jnp.dtype(meta.pop("dtype"))
        rank = meta.pop("rank")
        alpha_h = meta.pop("alpha_h")
        model = cls(rank, dtype=dtype, alpha_h=alpha_h, mesh=mesh,
                    **meta)
        model.rho = rho  # exact resumed forgetting rate
        from nmftpu import checkpoint as CK

        if CK._HAS_ORBAX and os.path.isdir(
            os.path.join(path, "online_state")
        ):
            ckptr = CK.ocp.StandardCheckpointer()
            state = ckptr.restore(os.path.join(path, "online_state"))
        else:  # pragma: no cover
            data = np.load(os.path.join(path, "online_state.npz"))
            state = {k: data[k] for k in ("H", "A", "B")}

        def place(x):
            x = jnp.asarray(x, dtype)
            if model._shardings is not None:
                x = jax.device_put(x, model._shardings["H"])
            return x

        model.H = place(state["H"])
        model._A = place(state["A"])
        model._B = place(state["B"])
        model.n_steps = int(n_steps)
        return model

    def set_components(self, H):
        """Replace the resident H (keeping the mesh sharding if one was
        configured). The A/B accumulators are kept — this mirrors
        sklearn's partial_fit using self.components_ in place."""
        H = jnp.asarray(H, self.dtype)
        if self._shardings is not None:
            H = jax.device_put(H, self._shardings["H"])
        self.H = H

    def partial_fit(self, Xb, H0=None):
        """One online step on a row batch (fresh W solve, like
        sklearn's MiniBatchNMF.partial_fit). Returns self."""
        Xb = self._place(jnp.asarray(Xb, self.dtype))
        self._ensure_state(Xb, H0)
        l1_w, l2_w, l1_h, l2_h = self._regs(Xb.shape[0], Xb.shape[1])
        _, self.H, self._A, self._B, _ = minibatch_step(
            Xb, None, self.H, self._A, self._B, self.rho,
            beta=self.beta, l1_w=l1_w, l2_w=l2_w, l1_h=l1_h, l2_h=l2_h,
            gamma=self.gamma, fresh=True,
            fresh_max_iter=self.fresh_max_iter,
            fresh_tol=self.transform_tol,
        )
        self.n_steps += 1
        return self

    def transform(self, X):
        """Solve W for rows of X against the current H (frozen)."""
        if self.H is None:
            raise ValueError("OnlineNMF has not seen any data yet")
        X = self._place(jnp.asarray(X, self.dtype))
        l1_w, l2_w, _, _ = self._regs(X.shape[0], X.shape[1])
        return solve_w(
            X, self.H, self.beta, l1_w, l2_w, self.gamma,
            max_iter=self.transform_max_iter, tol=self.transform_tol,
        )


def _can_fuse(V, monitor, dtype):
    """Epoch fusion needs V device-resident (a real in-memory ndarray
    within budget — memmap/sparse sources stay on the streaming host
    loop) and no per-batch host monitoring."""
    if monitor:
        return False
    arr = getattr(V, "X", V)  # unwrap the facade's _RowSource
    if isinstance(arr, jax.Array):
        return True  # already device-resident: trivially fusible
    if not isinstance(arr, np.ndarray) or isinstance(arr, np.memmap):
        return False
    return arr.shape[0] * arr.shape[1] * jnp.dtype(dtype).itemsize \
        <= backend.memory_budget("NMFTPU_MINIBATCH_FUSED_BUDGET_BYTES")


def _flat_item_shardings(mesh):
    """Column-shard spec over ALL devices of any mesh (the online
    state is H-shaped — only the item axis is large)."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    flat = Mesh(np.asarray(list(mesh.devices.flat)), ("mb_items",))
    return {
        "H": NamedSharding(flat, P(None, "mb_items")),
        "X": NamedSharding(flat, P(None, "mb_items")),
    }


def minibatch_fit(
    V, rank, *, batch_size=1024, max_iter=200, beta=2.0,
    forget_factor=0.7, alpha_w=0.0, alpha_h="same", l1_ratio=0.0,
    tol=1e-4, max_no_improvement=10, fresh_restarts=False,
    fresh_restarts_max_iter=30, transform_max_iter=None,
    W0=None, H0=None, dtype=jnp.float32, verbose=0, fused="auto",
    mesh=None,
):
    """Full mini-batch fit over a host row-major array (sklearn's
    MiniBatchNMF._fit_transform loop, cycling fixed batch slices).

    V may be any object supporting `V[a:b]` row slicing + `.shape` —
    a numpy array, np.memmap, or h5py dataset — so datasets far beyond
    HBM stream through panel by panel. Early stopping matches sklearn:
    relative H change <= tol, and an EWA of the per-sample batch cost
    with a max_no_improvement patience (pass tol=0 AND
    max_no_improvement=None to run exactly max_iter epochs).

    Returns (W, H, n_iter, n_steps).
    """
    n, m = V.shape
    rank = int(rank)
    batch_size = min(int(batch_size), n)
    gamma = beta_gamma(float(beta))
    rho = float(forget_factor) ** (batch_size / float(n))
    a_w = float(alpha_w)
    a_h = a_w if alpha_h == "same" else float(alpha_h)
    tmax = (max_iter if transform_max_iter is None
            else int(transform_max_iter))

    if W0 is None or H0 is None:
        raise ValueError(
            "minibatch_fit requires explicit W0/H0 (use "
            "nmftpu.init.initialize_factors or the sklearn facade, "
            "which resolves init= exactly like sklearn)"
        )
    W = jnp.asarray(W0, dtype)
    H = jnp.asarray(H0, dtype)
    sh = _flat_item_shardings(mesh) if mesh is not None else None
    if sh is not None:
        H = jax.device_put(H, sh["H"])
    A = H
    B = jnp.ones_like(H)

    slices = [
        (s, min(s + batch_size, n)) for s in range(0, n, batch_size)
    ]
    steps_per_iter = len(slices)
    n_steps_max = int(max_iter) * steps_per_iter
    monitor = (tol is not None and tol > 0) or (
        max_no_improvement is not None
    )

    l1_w = m * a_w * float(l1_ratio)
    l2_w = m * a_w * (1.0 - float(l1_ratio))

    H_buffer = H
    ewa = None
    ewa_min = None
    no_improvement = 0
    step = 0

    if fused == "auto":
        use_fused = _can_fuse(V, monitor, dtype)
    else:
        use_fused = bool(fused)
        if use_fused and monitor:
            raise ValueError(
                "fused=True cannot honor per-batch early stopping "
                "(tol > 0 / max_no_improvement); pass tol=0 and "
                "max_no_improvement=None, or fused=False/'auto'"
            )
        if use_fused and not isinstance(
            getattr(V, "X", V), (np.ndarray, jax.Array)
        ):
            raise ValueError(
                "fused=True needs an in-memory dense ndarray (memmap/"
                "sparse sources stream through the host loop); use "
                "fused=False/'auto'"
            )
    if use_fused:
        # one compiled dispatch per epoch (bit-identical to the
        # per-batch loop below — same step fn, same order)
        Vd = jnp.asarray(getattr(V, "X", V), dtype)
        if sh is not None:
            Vd = jax.device_put(Vd, sh["X"])
        tail_rows = n - (len(slices) - 1) * batch_size
        kw = dict(
            batch_size=batch_size, beta=float(beta), l1_w=l1_w,
            l2_w=l2_w,
            l1_h_full=batch_size * a_h * float(l1_ratio),
            l2_h_full=batch_size * a_h * (1.0 - float(l1_ratio)),
            l1_h_tail=tail_rows * a_h * float(l1_ratio),
            l2_h_tail=tail_rows * a_h * (1.0 - float(l1_ratio)),
            gamma=gamma, fresh=fresh_restarts,
            fresh_max_iter=int(fresh_restarts_max_iter),
            fresh_tol=float(tol or 0.0),
        )
        for _ in range(int(max_iter)):
            W, H, A, B = epoch_fused(Vd, W, H, A, B, rho, **kw)
        if fresh_restarts:
            W = solve_w(Vd, H, float(beta), l1_w, l2_w, gamma,
                        max_iter=tmax, tol=float(tol or 0.0))
        return W, H, int(max_iter), n_steps_max

    for step in range(n_steps_max):
        lo, hi = slices[step % steps_per_iter]
        Xb = jnp.asarray(V[lo:hi], dtype)
        if sh is not None:
            Xb = jax.device_put(Xb, sh["X"])
        b = hi - lo
        l1_h = b * a_h * float(l1_ratio)
        l2_h = b * a_h * (1.0 - float(l1_ratio))
        Wb, H, A, B, cost = minibatch_step(
            Xb, (None if fresh_restarts else W[lo:hi]), H, A, B, rho,
            beta=float(beta), l1_w=l1_w, l2_w=l2_w, l1_h=l1_h,
            l2_h=l2_h, gamma=gamma, fresh=fresh_restarts,
            fresh_max_iter=int(fresh_restarts_max_iter),
            fresh_tol=float(tol or 0.0),
            with_cost=monitor,
        )
        W = W.at[lo:hi].set(Wb) if not fresh_restarts else W
        if monitor and step > 0:
            cost = float(cost)
            if verbose:
                print(f"[nmftpu.minibatch] step {step + 1}/"
                      f"{n_steps_max} batch cost {cost:.6g}")
            alpha = min(b / (n + 1), 1.0)
            ewa = cost if ewa is None else ewa * (1 - alpha) + cost * alpha
            h_diff = float(
                jnp.linalg.norm(H - H_buffer) / jnp.linalg.norm(H)
            )
            if tol and tol > 0 and h_diff <= tol:
                break
            if ewa_min is None or ewa < ewa_min:
                no_improvement = 0
                ewa_min = ewa
            else:
                no_improvement += 1
            if (max_no_improvement is not None
                    and no_improvement >= max_no_improvement):
                break
        H_buffer = H

    if fresh_restarts:
        if _can_fuse(V, False, dtype):
            # in-memory within budget: the exact full-matrix solve
            # (bit-identical to sklearn and to the fused path)
            Vd = jnp.asarray(getattr(V, "X", V), dtype)
            if sh is not None:
                Vd = jax.device_put(Vd, sh["X"])
            W = solve_w(Vd, H, float(beta), l1_w, l2_w, gamma,
                        max_iter=tmax, tol=float(tol or 0.0))
        else:
            # out-of-core source: never materialize V on device
            W = _solve_w_streamed(V, H, slices, float(beta), l1_w,
                                  l2_w, gamma, tmax,
                                  float(tol or 0.0), dtype, sh)

    n_steps = step + 1
    n_iter = int(math.ceil(n_steps / steps_per_iter))
    return W, H, n_iter, n_steps


def _solve_w_streamed(V, H, slices, beta, l1_w, l2_w, gamma, max_iter,
                      tol, dtype, sh):
    """Final fresh-restarts W solve without materializing V on device:
    the rows of W are independent given H, so each batch panel solves
    separately. The flat start uses the GLOBAL mean (streamed), like
    sklearn's _solve_W on the full X; the tol early-stop applies per
    panel rather than on the global W norm — a documented deviation
    that only changes WHEN iteration stops, not the fixed point."""
    def place(lo, hi):
        Xb = jnp.asarray(V[lo:hi], dtype)
        return jax.device_put(Xb, sh["X"]) if sh is not None else Xb

    # pass 1: the global mean for the flat start (panel at a time)
    total = 0.0
    count = 0
    for lo, hi in slices:
        Xb = place(lo, hi)
        total += float(jnp.sum(Xb))
        count += (hi - lo) * Xb.shape[1]
    mean_v = total / count
    # pass 2: per-panel solves; only the (b, r) results are retained
    parts = [
        solve_w(place(lo, hi), H, beta, l1_w, l2_w, gamma,
                max_iter=max_iter, tol=tol, mean_v=mean_v)
        for lo, hi in slices
    ]
    return jnp.concatenate(parts, axis=0)
