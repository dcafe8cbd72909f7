"""scikit-learn-compatible estimator facade over the nmftpu engines.

The reference is consumed through a host-language binding whose calling
convention its users already know (nmfgpu4R's ``nmf(data, r, ...)`` —
SURVEY.md C19); the Python world's equivalent muscle memory is
``sklearn.decomposition.NMF``. This module lets that code run on the GPU by
swapping the import: same constructor surface, same ``fit`` /
``fit_transform`` / ``transform`` / ``inverse_transform`` methods, same
fitted attributes (``components_``, ``reconstruction_err_``, ``n_iter_``),
with the work routed through nmftpu's drivers (dense, sparse engines, or
a device mesh).

Semantics notes vs sklearn (`sklearn/decomposition/_nmf.py`):
  * solver="mu" (multiplicative) AND solver="cd" (sklearn's DEFAULT:
    HALS coordinate descent — nmftpu runs the identical cyclic column
    sweeps, linalg.dense._hals_half_sweep) are both native and
    factor-parity tested; "cd" is Frobenius-only, as in sklearn.
  * ``init`` resolves exactly like sklearn's ``_initialize_nmf``:
    ``None`` → deterministic ``'nndsvda'`` when the rank permits, else
    ``'random'``; all NNDSVD variants are implemented
    (nmftpu/init/nndsvd.py — sign-invariant, so the exact SVD here and
    sklearn's randomized SVD agree to numerical precision).
  * ``n_components='auto'``/``None`` resolves like sklearn (a custom H's
    row count, else ``n_features``) — but nmftpu engines require
    ``rank <= min(n, m)``, so an overcomplete default on a short-wide
    matrix raises a clear error instead of fitting; set ``n_components``
    explicitly there.
  * ``tol`` stops on the drop of the Frobenius error between convergence
    checks (an absolute threshold on |Δ‖V−WH‖_F|), not sklearn's
    relative-to-initial-error criterion; ``tol=0`` runs ``max_iter``
    exactly, matching sklearn.
  * ``alpha_W``/``alpha_H``/``l1_ratio`` regularization is mapped for
    the default 'cd' solver exactly (sklearn's n_features/n_samples
    scaling; L2 on the Gram diagonal, L1 off the numerators); for other
    algorithms use the penalized forms (ACLS/AHCLS/GDCLS).
  * ``beta_loss`` is fully covered for solver='mu': the named losses
    AND any float (generalized beta divergence with sklearn's gamma
    exponent and beta<1 stabilization — factor parity tested at
    beta ∈ {0.5, 1.5, 2.5} and 'itakura-saito'). transform() under a
    general beta folds in via W-only beta-MU steps on dense rows
    (foldin._beta_w_loop_dense); sparse inputs at a general beta
    raise with a densify hint.
  * Extra engine parameters (``mesh``, ``strategy``, ``v_storage``,
    ``num_runs``, ``algorithm``) default to the sklearn-equivalent
    behavior and are ignored by sklearn-written call sites.

All three public sklearn NMF entry points are covered: :class:`NMF`,
:class:`MiniBatchNMF` (online/out-of-core, see nmftpu.minibatch), and
:func:`non_negative_factorization` (module-level function, both
``update_H`` modes).
"""

from __future__ import annotations

import numpy as np
from sklearn.base import BaseEstimator, TransformerMixin

from nmftpu.config import (
    Algorithm,
    Initialization,
    NmfConfig,
    Objective,
    ThresholdType,
)

_BETA_LOSS_STRINGS = {
    "frobenius": 2.0,
    "kullback-leibler": 1.0,
    "itakura-saito": 0.0,
}


def _beta_objective(beta_loss):
    """sklearn beta_loss (string or float) -> (Objective, beta | None).

    Full sklearn coverage: the three named losses plus any finite float
    (solver='mu'). beta=2/1 select the specialized Frobenius/KL engines;
    everything else is the generalized beta path (NmfConfig.beta).
    """
    if isinstance(beta_loss, str):
        if beta_loss not in _BETA_LOSS_STRINGS:
            raise ValueError(
                f"beta_loss={beta_loss!r} is not supported; use "
                "'frobenius' (2), 'kullback-leibler' (1), "
                "'itakura-saito' (0), or a float"
            )
        b = _BETA_LOSS_STRINGS[beta_loss]
    else:
        try:
            b = float(beta_loss)
        except (TypeError, ValueError):
            raise ValueError(
                f"beta_loss={beta_loss!r} is not supported; use a "
                "float or one of 'frobenius'/'kullback-leibler'/"
                "'itakura-saito'"
            ) from None
    if b == 2.0:
        return Objective.FROBENIUS, None
    if b == 1.0:
        return Objective.KL, None
    return Objective.BETA, b

_INITS = {
    "random": Initialization.ALL_RANDOM_VALUES,
    "custom": Initialization.COPY_EXISTING,
    "nndsvd": Initialization.NNDSVD,
    "nndsvda": Initialization.NNDSVDA,
    "nndsvdar": Initialization.NNDSVDAR,
    # nmftpu extensions beyond sklearn's init set (same strings as
    # nmftpu.api.nmf's aliases)
    "kmeans": Initialization.K_MEANS_AND_RANDOM_VALUES,
    "mean_columns": Initialization.MEAN_COLUMNS,
}


def _as_nmftpu_input(X):
    """numpy/JAX dense, scipy.sparse, or nmftpu sparse -> driver input."""
    from nmftpu import sparse as hs

    if isinstance(X, hs.SparseMatrix):
        return X, True
    if hasattr(X, "tocsr") and hasattr(X, "nnz"):  # scipy.sparse duck type
        return hs.from_scipy(X), True
    return np.asarray(X), False


class NMF(TransformerMixin, BaseEstimator):
    """Drop-in ``sklearn.decomposition.NMF`` running on nmftpu engines.

    Parameters follow sklearn where they exist there (``n_components``,
    ``init``, ``solver``, ``beta_loss``, ``tol``, ``max_iter``,
    ``random_state``, ``verbose``); the extension parameters select
    nmftpu machinery:

    algorithm: None (resolved from ``solver``: 'cd' -> HALS, 'mu' ->
      MU; weighted runs imply MU) or any nmftpu ``Algorithm``/string
      ("mu", "hals", "als", "acls", "ahcls", "gdcls", "nsnmf") —
      explicit algorithm= wins over solver.
    mesh: a 2-D ('users','items') ``jax.sharding.Mesh`` — fits run
      sharded (GSPMD dense path or the sparse sharded engines).
    strategy: sparse engine ("auto" | "densified" | "ell" | "scatter";
      with a mesh, "ell"/"scatter"/"ring" select the per-tile sharded
      engine and "densified" is rejected — single-device only).
    v_storage: "float32" | "bfloat16" | "int8" — V's on-device storage
      (dense + densified paths; see docs/TUNING.md).
    num_runs: best-of-N random restarts (reference ``numRuns``).
    alpha_confidence: implicit-feedback weighting c = 1 + alpha*v —
      weighted MU with the default algorithm, exact iALS with
      ``algorithm="als"`` (lambda_w/lambda_h are its ridge).
    """

    def __init__(
        self,
        n_components="auto",
        *,
        init=None,
        solver="cd",
        beta_loss="frobenius",
        tol=1e-4,
        max_iter=200,
        random_state=None,
        alpha_W=0.0,
        alpha_H="same",
        l1_ratio=0.0,
        verbose=0,
        shuffle=False,
        algorithm=None,
        mesh=None,
        strategy="auto",
        v_storage="float32",
        num_runs=1,
        check_interval=10,
        dtype="float32",
        eps=1e-9,
        alpha_confidence=0.0,
        lambda_w=0.0,
        lambda_h=0.0,
    ):
        self.n_components = n_components
        self.init = init
        self.solver = solver
        self.beta_loss = beta_loss
        self.tol = tol
        self.max_iter = max_iter
        self.random_state = random_state
        self.alpha_W = alpha_W
        self.alpha_H = alpha_H
        self.l1_ratio = l1_ratio
        self.verbose = verbose
        self.shuffle = shuffle
        self.algorithm = algorithm
        self.mesh = mesh
        self.strategy = strategy
        self.v_storage = v_storage
        self.num_runs = num_runs
        self.check_interval = check_interval
        self.dtype = dtype
        self.eps = eps
        self.alpha_confidence = alpha_confidence
        self.lambda_w = lambda_w
        self.lambda_h = lambda_h

    # -- parameter translation ------------------------------------------

    def _resolve_rank(self, X_shape, W, H):
        """sklearn's n_components semantics: 'auto' (the 1.x default)
        infers from a provided custom H (or W), else uses n_features;
        None is the legacy alias for n_features."""
        r = self.n_components
        if r is None or (isinstance(r, str) and r == "auto"):
            if H is not None:
                return int(np.asarray(H).shape[0])
            if W is not None:
                return int(np.asarray(W).shape[1])
            return int(X_shape[1])
        return int(r)

    def _sklearn_cd_reg(self, shape):
        """sklearn's alpha_W/alpha_H/l1_ratio -> per-side (l1, l2), with
        its >=1.0 scaling: W penalties scale by n_features, H penalties
        by n_samples (see sklearn _compute_regularization)."""
        n_samples, n_features = shape
        a_w = float(self.alpha_W)
        a_h = a_w if self.alpha_H == "same" else float(self.alpha_H)
        l1r = float(self.l1_ratio)
        return (
            n_features * a_w * l1r,            # l1_w
            n_features * a_w * (1.0 - l1r),    # l2_w
            n_samples * a_h * l1r,             # l1_h
            n_samples * a_h * (1.0 - l1r),     # l2_h
        )

    def _config(self, r, init_method, shape=None):
        if self.solver not in ("mu", "cd"):
            raise NotImplementedError(
                f"solver={self.solver!r}: 'mu' and 'cd' (HALS "
                "coordinate descent, sklearn's default) are implemented"
            )
        objective, beta = _beta_objective(self.beta_loss)
        if (self.solver == "cd" and self.algorithm is None
                and self.alpha_confidence == 0.0
                and objective is not Objective.FROBENIUS):
            # sklearn raises for cd + beta_loss != frobenius too
            raise ValueError(
                "solver='cd' supports beta_loss='frobenius' only "
                "(as in sklearn); pass solver='mu' for other losses"
            )
        if self.shuffle and self.solver == "cd" \
                and self.algorithm is None:
            raise NotImplementedError(
                "shuffle=True (randomized CD coordinate order) is not "
                "implemented; nmftpu runs the cyclic sweep "
                "(shuffle=False, sklearn's default)"
            )
        has_reg = bool(self.alpha_W) or (
            self.alpha_H not in ("same", 0.0, 0)
        )
        if has_reg and not (self.solver == "cd"
                            and self.algorithm is None
                            and self.alpha_confidence == 0.0):
            raise NotImplementedError(
                "alpha_W/alpha_H regularization is mapped for the 'cd' "
                "solver (HALS) only; for other algorithms use the "
                "penalized forms (algorithm='acls' with "
                "lambda_w/lambda_h, 'ahcls', 'gdcls' — see "
                "nmftpu.NmfConfig)"
            )
        # explicit algorithm= (the nmftpu power knob) wins over solver;
        # otherwise sklearn semantics: 'cd' -> HALS, 'mu' -> MU. The
        # alpha_confidence extension implies the weighted MU model when
        # no algorithm is named (HALS has no weighted form).
        alg = self.algorithm
        if alg is None:
            if self.alpha_confidence > 0.0:
                alg = Algorithm.MU
            elif self.solver == "cd":
                alg = Algorithm.HALS
            else:
                alg = Algorithm.MU
        elif not isinstance(alg, Algorithm):
            alg = Algorithm(alg)
        seed = self.random_state
        if seed is None:
            seed = 0
        elif not isinstance(seed, (int, np.integer)):
            raise ValueError(
                "random_state must be an int seed or None (Generator "
                "instances are not hashable into device RNG keys)"
            )
        lam_w, lam_h = float(self.lambda_w), float(self.lambda_h)
        l1_w = l1_h = 0.0
        if alg is Algorithm.HALS and shape is not None and (
            self.alpha_W or self.alpha_H not in ("same", 0.0, 0)
        ):
            l1_w, l2_w, l1_h, l2_h = self._sklearn_cd_reg(shape)
            lam_w += l2_w
            lam_h += l2_h
        return NmfConfig(
            rank=int(r),
            algorithm=alg,
            objective=objective,
            beta=beta,
            init_method=init_method,
            seed=int(seed),
            num_iterations=int(self.max_iter),
            num_runs=int(self.num_runs),
            threshold_value=float(self.tol),
            threshold_type=ThresholdType.FROBENIUS,
            check_interval=int(self.check_interval),
            alpha_confidence=float(self.alpha_confidence),
            lambda_w=lam_w,
            lambda_h=lam_h,
            l1_w=l1_w,
            l1_h=l1_h,
            v_storage=self.v_storage,
            dtype=self.dtype,
            eps=float(self.eps),
            verbosity=min(int(self.verbose), 3),
        )

    # -- sklearn API -----------------------------------------------------

    def fit_transform(self, X, y=None, W=None, H=None):
        """Factorize X ≈ W @ H; returns W and stores H as components_."""
        data, is_sparse = _as_nmftpu_input(X)
        shape = data.shape
        r = self._resolve_rank(shape, W, H)
        if self.init == "custom":
            if W is None or H is None:
                raise ValueError("init='custom' requires both W and H")
            init_method = Initialization.COPY_EXISTING
        else:
            if W is not None or H is not None:
                import warnings

                warnings.warn(
                    "When init != 'custom', provided W or H are ignored",
                    RuntimeWarning, stacklevel=2,
                )
                W = H = None
            if self.init is None:
                # sklearn's default: deterministic NNDSVDa seeding when
                # the rank permits, else random (_initialize_nmf)
                init_method = (
                    Initialization.NNDSVDA if r <= min(shape)
                    else Initialization.ALL_RANDOM_VALUES
                )
            elif self.init in _INITS:
                init_method = _INITS[self.init]
            else:
                raise ValueError(f"unknown init {self.init!r}")
        cfg = self._config(r, init_method, shape=shape)
        if (cfg.objective is Objective.BETA and cfg.beta <= 0):
            # sklearn's divergence guard (beta<=0 blows up on zeros)
            has_zero = (
                data.nnz < shape[0] * shape[1]
                or float(np.min(data.values
                                if hasattr(data, "values")
                                else data.data)) == 0.0
            ) if is_sparse else float(np.min(data)) == 0.0
            if has_zero:
                raise ValueError(
                    "When beta_loss <= 0 and X contains zeros, the "
                    "solver may diverge. Please add small values to X, "
                    "or use a positive beta_loss."
                )

        from nmftpu.api import dispatch

        res = dispatch(data, cfg, W0=W, H0=H, mesh=self.mesh,
                       strategy=self.strategy)

        self.components_ = np.asarray(res.H)
        self.n_components_ = self.components_.shape[0]
        self.n_features_in_ = shape[1]
        self.n_iter_ = int(res.num_iterations)
        # sklearn reports sqrt(2·beta_divergence): the Frobenius NORM for
        # beta=2, sqrt(2·D) otherwise (_beta_divergence square_root=True;
        # res.kl_error carries D for both KL and generalized beta)
        if cfg.objective in (Objective.KL, Objective.BETA):
            self.reconstruction_err_ = float(
                np.sqrt(2.0 * max(res.kl_error, 0.0))
            )
        else:
            self.reconstruction_err_ = float(res.frobenius_error)
        return np.asarray(res.W)

    def fit(self, X, y=None, **params):
        self.fit_transform(X, **params)
        return self

    def transform(self, X):
        """Project NEW rows onto the fitted components (H frozen) — the
        fold-in path (nmftpu.foldin.transform, sklearn-parity tested)."""
        self._check_fitted()
        from nmftpu.foldin import transform as fold_transform

        data, _ = _as_nmftpu_input(X)
        t_obj, t_beta = _beta_objective(self.beta_loss)
        if t_obj is Objective.BETA:
            # generalized-beta projection needs dense rows (the
            # denominator samples the full reconstruction, exactly as
            # sklearn's _fit_transform(update_H=False) does)
            if hasattr(data, "to_csr"):
                data = np.asarray(data.to_csr().todense())
            obj = "beta"
        else:
            obj = "kl" if t_obj is Objective.KL else "frobenius"
        seed = self.random_state if isinstance(
            self.random_state, (int, np.integer)) else 0
        # fold-in supports mu and one-shot als; the penalized algorithms
        # fall back to the mu projection (their H-side penalties do not
        # apply to a W-only solve)
        if self.algorithm in ("als", Algorithm.ALS):
            alg = "als"
        elif (self.algorithm in ("hals", Algorithm.HALS)
              or (self.algorithm is None and self.solver == "cd"
                  and self.alpha_confidence == 0.0)):
            alg = "hals"  # project with the solver the model was fit with
        else:
            alg = "mu"
        kwargs = {}
        if alg == "hals":
            kwargs["num_iterations"] = int(self.max_iter)
            kwargs["lambda_w"] = float(self.lambda_w)
        elif alg == "mu":
            kwargs["objective"] = obj
            kwargs["num_iterations"] = int(self.max_iter)
            kwargs["eps"] = float(self.eps) if self.eps else 1e-12
            if obj == "beta":
                kwargs["beta"] = float(t_beta)
            # sklearn's transform (update_H=False) initializes W to the
            # constant sqrt(mean(X)/k) (sklearn _nmf.py:1225); matching
            # it makes the MU trajectories identical, not just the
            # fixed point
            if hasattr(data, "to_coo"):  # SparseMatrix
                x_mean = float(np.sum(data.to_coo().data)) / (
                    data.shape[0] * data.shape[1])
            else:
                x_mean = float(np.mean(data))
            k = self.components_.shape[0]
            kwargs["W0"] = np.full(
                (data.shape[0], k), np.sqrt(max(x_mean, 0.0) / k),
                dtype=np.float32)
        else:
            # the projection must solve the SAME weighted/regularized
            # system the model was fit with (iALS extension params)
            kwargs["alpha_confidence"] = float(self.alpha_confidence)
            kwargs["lambda_w"] = float(self.lambda_w)
        out = fold_transform(
            data, self.components_, algorithm=alg, seed=int(seed),
            **kwargs,
        )
        return np.asarray(out.W)

    def inverse_transform(self, X=None, *, Xt=None):
        self._check_fitted()
        Wt = X if X is not None else Xt
        if Wt is None:
            raise ValueError("pass the transformed array")
        return np.asarray(Wt) @ self.components_

    def _check_fitted(self):
        if not hasattr(self, "components_"):
            raise AttributeError(
                "This NMF instance is not fitted yet; call fit or "
                "fit_transform first"
            )


class _RowSource:
    """Row-slicing adapter: yields DENSE row panels from dense arrays,
    np.memmap, or scipy.sparse — only batch-sized panels ever densify."""

    def __init__(self, X):
        self.X = X
        self.shape = X.shape

    def __getitem__(self, sl):
        blk = self.X[sl]
        if hasattr(blk, "toarray"):
            return blk.toarray()
        return np.asarray(blk)


class MiniBatchNMF(TransformerMixin, BaseEstimator):
    """Drop-in ``sklearn.decomposition.MiniBatchNMF`` on the nmftpu
    online engine (nmftpu/minibatch.py): W per row mini-batch, H through
    forgetting-weighted sufficient-statistic accumulators — out-of-core
    and streaming NMF with ``partial_fit``.

    Same constructor surface and fitted attributes as sklearn
    (``components_``, ``reconstruction_err_``, ``n_iter_``,
    ``n_steps_``); guard-for-guard MU numerics, parity-tested at
    float64 (tests/test_minibatch.py) for frobenius, KL and float
    beta_loss. X may be dense, np.memmap, or scipy.sparse — batches
    densify panel by panel, so the dataset never needs to fit in HBM.
    """

    def __init__(
        self,
        n_components="auto",
        *,
        init=None,
        batch_size=1024,
        beta_loss="frobenius",
        tol=1e-4,
        max_no_improvement=10,
        max_iter=200,
        alpha_W=0.0,
        alpha_H="same",
        l1_ratio=0.0,
        forget_factor=0.7,
        fresh_restarts=False,
        fresh_restarts_max_iter=30,
        transform_max_iter=None,
        random_state=None,
        verbose=0,
        dtype="float32",
        mesh=None,
    ):
        self.n_components = n_components
        self.init = init
        self.batch_size = batch_size
        self.beta_loss = beta_loss
        self.tol = tol
        self.max_no_improvement = max_no_improvement
        self.max_iter = max_iter
        self.alpha_W = alpha_W
        self.alpha_H = alpha_H
        self.l1_ratio = l1_ratio
        self.forget_factor = forget_factor
        self.fresh_restarts = fresh_restarts
        self.fresh_restarts_max_iter = fresh_restarts_max_iter
        self.transform_max_iter = transform_max_iter
        self.random_state = random_state
        self.verbose = verbose
        self.dtype = dtype
        self.mesh = mesh

    _resolve_rank = NMF._resolve_rank
    _check_fitted = NMF._check_fitted
    inverse_transform = NMF.inverse_transform

    def _beta(self):
        obj, beta = _beta_objective(self.beta_loss)
        if obj is Objective.FROBENIUS:
            return 2.0
        if obj is Objective.KL:
            return 1.0
        return float(beta)

    def _seed(self):
        seed = self.random_state
        if seed is None:
            return 0
        if not isinstance(seed, (int, np.integer)):
            raise ValueError(
                "random_state must be an int seed or None"
            )
        return int(seed)

    def _init_wh(self, X, r, W, H):
        """Resolve init exactly like sklearn's _initialize_nmf default
        chain (None -> nndsvda when the rank permits, else random)."""
        if self.init == "custom":
            if W is None or H is None:
                raise ValueError("init='custom' requires both W and H")
            return np.asarray(W), np.asarray(H)
        if W is not None or H is not None:
            import warnings

            warnings.warn(
                "When init != 'custom', provided W or H are ignored",
                RuntimeWarning, stacklevel=3,
            )
        n, m = X.shape
        init = self.init
        if init is None:
            init = "nndsvda" if r <= min(n, m) else "random"
        if init in ("nndsvd", "nndsvda", "nndsvdar"):
            from nmftpu.init.nndsvd import nndsvd_init

            return nndsvd_init(X, r, variant=init, seed=self._seed())
        if init == "random":
            rng = np.random.default_rng(self._seed())
            mean = (
                float(X.mean()) if not hasattr(X, "tocsr")
                else X.sum() / (n * m)
            )
            avg = np.sqrt(max(mean, 1e-12) / r)
            W0 = avg * np.abs(rng.standard_normal((n, r)))
            H0 = avg * np.abs(rng.standard_normal((r, m)))
            return W0, H0
        raise ValueError(f"unknown init {init!r}")

    def fit_transform(self, X, y=None, W=None, H=None):
        from nmftpu import minibatch as MB

        beta = self._beta()
        src = _RowSource(X)
        if beta <= 0:
            # sklearn's divergence guard: beta<=0 needs strictly
            # positive data
            has_zero = (
                X.nnz < X.shape[0] * X.shape[1] or X.data.min() == 0
                if hasattr(X, "nnz") else float(np.min(X)) == 0
            )
            if has_zero:
                raise ValueError(
                    "When beta_loss <= 0 and X contains zeros, the "
                    "solver may diverge. Please add small values to X, "
                    "or use a positive beta_loss."
                )
        r = self._resolve_rank(X.shape, W, H)
        W0, H0 = self._init_wh(X, r, W, H)
        Wf, Hf, n_iter, n_steps = MB.minibatch_fit(
            src, r,
            batch_size=int(self.batch_size),
            max_iter=int(self.max_iter),
            beta=beta,
            forget_factor=float(self.forget_factor),
            alpha_w=float(self.alpha_W),
            alpha_h=self.alpha_H,
            l1_ratio=float(self.l1_ratio),
            tol=float(self.tol),
            max_no_improvement=self.max_no_improvement,
            fresh_restarts=bool(self.fresh_restarts),
            fresh_restarts_max_iter=int(self.fresh_restarts_max_iter),
            transform_max_iter=self.transform_max_iter,
            W0=W0, H0=H0, dtype=self.dtype,
            verbose=int(self.verbose), mesh=self.mesh,
        )
        self.components_ = np.asarray(Hf)
        self.n_components_ = int(r)
        self.n_features_in_ = X.shape[1]
        self.n_iter_ = int(n_iter)
        self.n_steps_ = int(n_steps)
        self.reconstruction_err_ = float(np.sqrt(2.0 * max(
            MB.divergence_blocked(
                src, Wf, Hf, beta, batch=int(self.batch_size),
                dtype=self.dtype,
            ), 0.0,
        )))
        return np.asarray(Wf)

    def fit(self, X, y=None, **params):
        self.fit_transform(X, **params)
        return self

    def partial_fit(self, X, y=None, W=None, H=None):
        """One online step on a row mini-batch (out-of-core / streaming
        fitting). W/H are honored on the FIRST call only, as in
        sklearn."""
        from nmftpu import minibatch as MB

        beta = self._beta()
        src = _RowSource(X)
        Xb = src[0:X.shape[0]]
        if not hasattr(self, "components_"):
            r = self._resolve_rank(X.shape, W, H)
            _, H0 = self._init_wh(X, r, W, H)
            bs = min(int(self.batch_size), X.shape[0])
            self._online = MB.OnlineNMF(
                r, beta=beta, batch_size=bs,
                forget_factor=float(self.forget_factor),
                n_rows_hint=X.shape[0],
                alpha_w=float(self.alpha_W), alpha_h=self.alpha_H,
                l1_ratio=float(self.l1_ratio),
                fresh_max_iter=int(self.fresh_restarts_max_iter),
                transform_max_iter=(
                    int(self.transform_max_iter)
                    if self.transform_max_iter is not None
                    else int(self.max_iter)
                ),
                transform_tol=float(self.tol),
                dtype=self.dtype, seed=self._seed(),
                mesh=self.mesh,
            )
            self._online.partial_fit(Xb, H0=H0)
            self.n_steps_ = 1
            self.n_features_in_ = X.shape[1]
        else:
            # the OnlineNMF's device-resident H (sharded when mesh=)
            # is the source of truth; only re-upload if the user
            # replaced components_ with their own array
            if self.components_ is not getattr(
                self, "_components_view", None
            ):
                self._online.set_components(self.components_)
            self._online.partial_fit(Xb)
            self.n_steps_ += 1
        self.components_ = np.asarray(self._online.H)
        self._components_view = self.components_
        self.n_components_ = self.components_.shape[0]
        return self

    def transform(self, X):
        """Solve W for X's rows against the fitted components (H
        frozen) — sklearn's _solve_W."""
        import jax.numpy as jnp

        from nmftpu import minibatch as MB

        self._check_fitted()
        beta = self._beta()
        src = _RowSource(X)
        n, m = X.shape
        a_w = float(self.alpha_W)
        l1_w = m * a_w * float(self.l1_ratio)
        l2_w = m * a_w * (1.0 - float(self.l1_ratio))
        tmax = (
            int(self.transform_max_iter)
            if self.transform_max_iter is not None
            else int(self.max_iter)
        )
        W = MB.solve_w(
            jnp.asarray(src[0:n], self.dtype),
            jnp.asarray(self.components_, self.dtype),
            beta, l1_w, l2_w, MB.beta_gamma(beta),
            max_iter=tmax, tol=float(self.tol),
        )
        return np.asarray(W)


def non_negative_factorization(
    X,
    W=None,
    H=None,
    n_components="auto",
    *,
    init=None,
    update_H=True,
    solver="cd",
    beta_loss="frobenius",
    tol=1e-4,
    max_iter=200,
    alpha_W=0.0,
    alpha_H="same",
    l1_ratio=0.0,
    random_state=None,
    verbose=0,
    shuffle=False,
    **engine_params,
):
    """Drop-in ``sklearn.decomposition.non_negative_factorization``
    (the module-level function API). Returns ``(W, H, n_iter)``.

    update_H=True delegates to the :class:`NMF` facade (same engines,
    same parity guarantees). update_H=False solves W with H held
    constant — solver='mu' runs multiplicative W steps under ANY
    beta_loss (sklearn _multiplicative_update_w guard-for-guard, from
    sklearn's init rule: custom W, else the sqrt(mean/r) flat start);
    solver='cd' runs cyclic HALS W sweeps from zeros (sklearn's
    _fit_coordinate_descent update_H=False). The W-only path runs
    ``max_iter`` full steps — sklearn's early-stop criteria there
    (10-step divergence checks / the CD violation ratio) stop at the
    same fixed point sooner; pass a smaller max_iter for budget control.
    Extra keyword ``engine_params`` (mesh, strategy, v_storage, dtype, ...)
    forward to the facade.
    """
    import jax
    import jax.numpy as jnp

    if update_H:
        est = NMF(
            n_components=n_components, init=init, solver=solver,
            beta_loss=beta_loss, tol=tol, max_iter=max_iter,
            alpha_W=alpha_W, alpha_H=alpha_H, l1_ratio=l1_ratio,
            random_state=random_state, verbose=verbose, shuffle=shuffle,
            **engine_params,
        )
        W_out = est.fit_transform(X, W=W, H=H)
        return W_out, est.components_, est.n_iter_

    if H is None:
        raise ValueError("update_H=False requires H (the fixed factor)")
    dtype = engine_params.pop("dtype", "float32")
    if engine_params:
        raise TypeError(
            f"unsupported parameters for update_H=False: "
            f"{sorted(engine_params)}"
        )
    data, is_sparse = _as_nmftpu_input(X)
    if is_sparse:
        # W-only solves are transform-sized; the dense panel keeps the
        # guard semantics identical to sklearn's dense branch
        data = data.todense()
    Xd = jnp.asarray(np.asarray(data), dtype)
    Hd = jnp.asarray(np.asarray(H), dtype)
    n, m = Xd.shape
    r = Hd.shape[0]
    # sklearn's _check_w_h shape validations
    if isinstance(n_components, (int, np.integer)) and r != n_components:
        raise ValueError(
            f"H has {r} rows but n_components={n_components} "
            "(sklearn raises on this mismatch too)"
        )
    if Hd.shape[1] != m:
        raise ValueError(
            f"H has {Hd.shape[1]} columns but X has {m} features"
        )
    objective, beta = _beta_objective(beta_loss)
    b = {Objective.FROBENIUS: 2.0, Objective.KL: 1.0}.get(
        objective, beta
    )
    if b <= 0 and float(jnp.min(Xd)) == 0.0:
        # sklearn's divergence guard (beta<=0 blows up on zeros)
        raise ValueError(
            "When beta_loss <= 0 and X contains zeros, the solver may "
            "diverge. Please add small values to X, or use a positive "
            "beta_loss."
        )
    if solver == "cd" and objective is not Objective.FROBENIUS:
        raise ValueError(
            "solver='cd' supports beta_loss='frobenius' only "
            "(as in sklearn); pass solver='mu' for other losses"
        )
    if solver == "cd" and shuffle:
        raise NotImplementedError(
            "shuffle=True (randomized CD coordinate order) is not "
            "implemented; nmftpu runs the cyclic sweep "
            "(shuffle=False, sklearn's default)"
        )
    if solver not in ("mu", "cd"):
        raise NotImplementedError(f"solver={solver!r}")
    a_w = float(alpha_W)
    l1_w = m * a_w * float(l1_ratio)
    l2_w = m * a_w * (1.0 - float(l1_ratio))

    # sklearn _check_w_h(update_H=False) IGNORES a provided W (with a
    # warning) and re-initializes: sqrt(X.mean()/r) flat for mu, zeros
    # for cd.
    if W is not None:
        import warnings

        warnings.warn(
            "When update_H=False, the provided initial W is not used.",
            RuntimeWarning, stacklevel=2,
        )
    if solver == "mu":
        avg = jnp.sqrt(jnp.mean(Xd) / r)
        W0 = jnp.full((n, r), avg, dtype=dtype)
    else:
        W0 = jnp.zeros((n, r), dtype=dtype)

    from nmftpu.linalg import dense as D

    if solver == "mu":
        gamma = D.beta_gamma(b)

        @jax.jit
        def run(Xd, Hd, W0):
            def body(_, Wc):
                Wc = D.beta_w_step(Xd, Wc, Hd, b, l1_w=l1_w,
                                   l2_w=l2_w, gamma=gamma)
                if b < 1.0:  # sklearn's beta<1 stabilization
                    Wc = jnp.where(Wc < D._STAB_EPS, 0.0, Wc)
                return Wc

            return jax.lax.fori_loop(0, int(max_iter), body, W0)
    else:

        @jax.jit
        def run(Xd, Hd, W0):
            G = D.gram_rows(Hd) + l2_w * jnp.eye(r, dtype=dtype)
            XHt = Xd @ Hd.T - l1_w

            def body(_, Wc):
                return D.hals_half_sweep(XHt, G, Wc)

            return jax.lax.fori_loop(0, int(max_iter), body, W0)

    W_out = run(Xd, Hd, W0)
    return np.asarray(W_out), np.asarray(H), int(max_iter)
