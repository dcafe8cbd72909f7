"""Configuration for an NMF computation.

``NmfConfig`` mirrors the reference's single config struct ``NmfDescription``
(SURVEY.md C1/§5.6: dims, rank, algorithm enum, init enum, seed,
numIterations, numRuns, threshold type+value, matrix format, plus a key/value
parameter list for the algorithm-specific knobs lambdaW/lambdaH/alphaW/
alphaH/lambda/theta). Mesh/sharding configuration is deliberately kept
separate (``nmftpu.parallel``) — it has no counterpart in the single-GPU
reference.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class Algorithm(str, enum.Enum):
    """NMF update algorithms (SURVEY.md C3–C7).

    * ``MU``    — Lee–Seung multiplicative updates (Frobenius or KL objective).
    * ``ALS``   — alternating least squares with negative-clamping.
    * ``ACLS``  — alternating constrained LS with sparsity penalties
                  ``lambda_w``/``lambda_h`` (Langville et al.).
    * ``AHCLS`` — ACLS plus Hoyer-sparseness targets ``alpha_w``/``alpha_h``.
    * ``GDCLS`` — gradient-descent constrained LS hybrid: MU-style update for
                  W, Tikhonov-regularized LS for H with scalar ``lambda_tik``.
    * ``NSNMF`` — non-smooth NMF (Pascual-Montano 2006): smoothing matrix
                  ``S = (1-theta) I + (theta/r) 11^T`` interposed, V ≈ W S H.
    * ``HALS``  — hierarchical ALS / coordinate descent (Cichocki & Phan;
                  sklearn's default 'cd' solver) — beyond the reference's
                  six: cyclic rank-1 column sweeps, typically the fastest
                  converger under Frobenius.
    """

    MU = "mu"
    ALS = "als"
    ACLS = "acls"
    AHCLS = "ahcls"
    GDCLS = "gdcls"
    NSNMF = "nsnmf"
    HALS = "hals"


class Objective(str, enum.Enum):
    """Reconstruction objective for MU-family updates.

    The reference's MU is Frobenius-only; KL divergence is additionally
    required by the north star (BASELINE.json `north_star`). Matches
    sklearn's ``beta_loss``: 2 → frobenius, 1 → kullback-leibler,
    0 → itakura-saito, any other float → BETA with ``NmfConfig.beta``
    (__post_init__ normalizes: BETA with beta=2/1/0 and ITAKURA_SAITO
    are canonicalized so engine dispatch sees one spelling per loss).
    """

    FROBENIUS = "frobenius"
    KL = "kullback-leibler"
    ITAKURA_SAITO = "itakura-saito"       # sugar: BETA with beta=0
    BETA = "beta-divergence"              # generalized; uses `beta`


class Initialization(str, enum.Enum):
    """The six reference initialization strategies (SURVEY.md C8), plus
    the NNDSVD family (sklearn's default init — deterministic SVD
    seeding; host-side one-time computation, see init/nndsvd.py)."""

    COPY_EXISTING = "copy_existing"
    ALL_RANDOM_VALUES = "all_random_values"
    MEAN_COLUMNS = "mean_columns"
    K_MEANS_AND_RANDOM_VALUES = "kmeans_random"
    K_MEANS_AND_NON_NEGATIVE_WTV = "kmeans_nonnegative_wtv"
    K_MEANS_AND_ABSOLUTE_WTV = "kmeans_absolute_wtv"
    NNDSVD = "nndsvd"
    NNDSVDA = "nndsvda"
    NNDSVDAR = "nndsvdar"


class ThresholdType(str, enum.Enum):
    """Convergence metric for the early-stop threshold (SURVEY.md C9)."""

    FROBENIUS = "frobenius"  # ||V - WH||_F
    RMSD = "rmsd"            # sqrt(||V - WH||_F^2 / (n*m))


class MatrixFormat(str, enum.Enum):
    """Input matrix storage formats accepted for V (SURVEY.md C10–C11)."""

    DENSE = "dense"
    CSR = "csr"
    CSC = "csc"
    COO = "coo"


@dataclasses.dataclass(frozen=True)
class NmfConfig:
    """Full description of one NMF computation (reference: ``NmfDescription``).

    Algorithm-specific knobs (the reference's key/value parameter list):

    * ``lambda_w``, ``lambda_h`` — ACLS sparsity penalties (also the l1
      diagonal shift reused by AHCLS/GDCLS paths).
    * ``alpha_w``, ``alpha_h``   — AHCLS Hoyer-sparseness targets in [0, 1].
    * ``lambda_tik``             — GDCLS Tikhonov regularizer for the H solve.
    * ``theta``                  — nsNMF smoothing in [0, 1] (0 == plain MU).
    * ``alpha_confidence``       — implicit-feedback confidence weighting
      c = 1 + alpha_confidence * v (0 disables; BASELINE.json config #3).
    """

    rank: int
    algorithm: Algorithm = Algorithm.MU
    objective: Objective = Objective.FROBENIUS
    init_method: Initialization = Initialization.ALL_RANDOM_VALUES
    seed: int = 0
    num_iterations: int = 200
    num_runs: int = 1

    # Convergence (SURVEY.md C9). threshold_value <= 0 disables early stop;
    # the error is still evaluated every `check_interval` iterations for the
    # stats stream.
    threshold_type: ThresholdType = ThresholdType.FROBENIUS
    threshold_value: float = 0.0
    check_interval: int = 10

    # Numerics. `eps` guards the multiplicative-update denominators.
    # `dtype` is the factor/compute dtype; `v_storage` separately controls
    # V's on-device storage (accumulations always run at >= f32).
    # `v_storage` controls how dense V is held in device memory for the
    # update loop:
    #   float32  — exact storage (default);
    #   bfloat16 — halves V traffic; bf16 x bf16 -> f32 contractions;
    #   int8     — quarter traffic via per-matrix-scale quantization;
    #              under Frobenius the dense MU dequantizes to bf16 and
    #              the ALS family contracts int8 x int8; under KL (MU/nsNMF) the scale folds into
    #              the blockwise bf16-GEMM numerators; under confidence
    #              weighting C = 1 + α·scale·Vq is rebuilt per panel.
    #              Dense + densified engines.
    # Factors W/H always stay in `dtype`; error checks read the original V.
    eps: float = 1e-9
    dtype: str = "float32"
    v_storage: str = "float32"

    # Update order within one iteration: "WH" (update W first, matches the
    # sklearn oracle's loop) or "HW" (classic Lee–Seung presentation).
    update_order: str = "WH"

    # MU half-step coupling: "gauss-seidel" (the reference's/sklearn's
    # form — the second half-step sees the first's fresh factor) or
    # "jacobi" (both half-steps from the incoming factors: identical
    # fixed points, different trajectory; the enabler for
    # single-V-read fused numerator kernels). Dense MU/Frobenius+KL
    # engines only; default stays gauss-seidel.
    mu_style: str = "gauss-seidel"

    # Generalized beta divergence exponent (objective=BETA only; sklearn
    # beta_loss float). Canonical form after __post_init__: beta=2 ->
    # FROBENIUS, beta=1 -> KL (the specialized fast paths), anything
    # else -> BETA with this knob (ITAKURA_SAITO spells BETA, beta=0),
    # so the engines dispatch on BETA + beta alone.
    beta: float | None = None

    # Algorithm-specific knobs.
    lambda_w: float = 0.0
    lambda_h: float = 0.0
    # HALS L1 penalties (sklearn cd semantics: subtracted from the
    # numerators; L2 is lambda_w/lambda_h on the Gram diagonal)
    l1_w: float = 0.0
    l1_h: float = 0.0
    alpha_w: float = 0.5
    alpha_h: float = 0.5
    lambda_tik: float = 0.0
    theta: float = 0.5
    alpha_confidence: float = 0.0

    # Masked factorization (matrix completion): "none" fits all nm
    # entries (zeros are data — the reference's semantics); "observed"
    # fits ONLY the stored nonzeros (the explicit-feedback completion
    # objective sum_obs d(v, wh)). MU fro/KL on the scatter, ELL and
    # grid engines; exact completion ALS (algorithm='als') on
    # scatter/ELL/grid. Zero-valued observations are indistinguishable
    # from unobserved (the sparse container's nonzero set IS the mask).
    # Errors/RMSD are reported over the observed set.
    mask: str = "none"

    # Per-row solver for the weighted/masked ALS normal equations
    # (iALS / completion ALS). "exact" = batched Cholesky (the oracle;
    # a batched factorization is sequential over its steps). "cg" =
    # warm-started Jacobi-preconditioned conjugate gradient, restarted
    # from the previous factors each outer iteration (Takács & Pilászy
    # 2011's ALS-CG): each step is one batched (n, r, r) matvec —
    # pure bandwidth, no factorization. With the outer ALS loop itself
    # iterative, cg_steps=3 tracks the exact trajectory to ~1e-3 and
    # converges to the same objective (tested).
    als_solver: str = "exact"
    cg_steps: int = 3

    # k-means init (SURVEY.md C8, §3.4).
    kmeans_max_iter: int = 25

    # Verbosity (reference C17, levels 0-3): 0 silent; 1 per-run summary
    # lines; 2 additionally per-convergence-check lines; 3 per-check
    # lines with elapsed wall-clock ms (the reference's full stats
    # record).
    verbosity: int = 0

    # Multi-run restarts as ONE vmapped program (all restarts advance in
    # lockstep on-device; best-of picked by on-device argmin). Trades
    # memory (num_runs x factors) for wall-clock; the reference runs
    # restarts sequentially, which remains the default.
    vectorize_runs: bool = False

    def __post_init__(self) -> None:
        # Coerce raw strings to the enums: these are str-enums, so a
        # plain string compares EQUAL but fails the `is` dispatch used
        # throughout the engines — NmfConfig(objective="kullback-leibler")
        # would silently run Frobenius otherwise.
        for field, enum_cls in (
            ("algorithm", Algorithm),
            ("objective", Objective),
            ("init_method", Initialization),
            ("threshold_type", ThresholdType),
        ):
            v = getattr(self, field)
            if not isinstance(v, enum_cls):
                object.__setattr__(self, field, enum_cls(v))
        # Canonicalize the dtype name so aliases ("double", "f8",
        # np.float64) cannot bypass the string-compared dtype rules
        # (f64 engine routing, plan dtype keys).
        import jax.numpy as _jnp

        object.__setattr__(self, "dtype", _jnp.dtype(self.dtype).name)
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.num_iterations < 0:
            raise ValueError(
                f"num_iterations must be >= 0, got {self.num_iterations}"
            )
        if self.num_runs < 1:
            raise ValueError(f"num_runs must be >= 1, got {self.num_runs}")
        if self.check_interval < 1:
            raise ValueError(
                f"check_interval must be >= 1, got {self.check_interval}"
            )
        if self.update_order not in ("WH", "HW"):
            raise ValueError(
                f"update_order must be 'WH' or 'HW', got {self.update_order!r}"
            )
        if self.mu_style not in ("gauss-seidel", "jacobi"):
            raise ValueError(
                f"mu_style must be 'gauss-seidel' or 'jacobi', "
                f"got {self.mu_style!r}"
            )
        if self.mu_style == "jacobi" and self.algorithm not in (
            Algorithm.MU,
        ):
            raise ValueError(
                "mu_style='jacobi' applies to the MU algorithm only "
                f"(got algorithm={self.algorithm.value!r}); the ALS "
                "family's half-steps are exact solves where "
                "Gauss-Seidel coupling is the algorithm"
            )
        if self.v_storage not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"v_storage must be float32|bfloat16|int8, "
                f"got {self.v_storage!r}"
            )
        # Normalize the beta-divergence family to one canonical spelling
        # FIRST — beta=1/2 become KL/FROBENIUS, so every objective-
        # algorithm guard below sees the canonical form (a beta=1.0
        # config must hit the same KL rules as objective='kl').
        if self.objective is Objective.ITAKURA_SAITO:
            if self.beta not in (None, 0.0):
                raise ValueError(
                    f"objective='itakura-saito' is beta=0; got beta="
                    f"{self.beta} — use objective='beta-divergence'"
                )
            object.__setattr__(self, "objective", Objective.BETA)
            object.__setattr__(self, "beta", 0.0)
        if self.objective is Objective.BETA:
            if self.beta is None:
                raise ValueError(
                    "objective='beta-divergence' requires the beta knob "
                    "(sklearn beta_loss; e.g. beta=0.5; 0 is "
                    "Itakura-Saito)"
                )
            b = float(self.beta)
            if not math.isfinite(b):
                raise ValueError(f"beta must be finite, got {self.beta}")
            if b == 2.0:
                object.__setattr__(self, "objective", Objective.FROBENIUS)
                object.__setattr__(self, "beta", None)
            elif b == 1.0:
                object.__setattr__(self, "objective", Objective.KL)
                object.__setattr__(self, "beta", None)
            else:
                object.__setattr__(self, "beta", b)
        elif self.beta is not None:
            raise ValueError(
                f"beta={self.beta} is only meaningful with objective="
                f"'beta-divergence'; got {self.objective}"
            )
        if self.objective is Objective.KL and self.algorithm not in (
            Algorithm.MU,
            Algorithm.NSNMF,
        ):
            raise ValueError(
                f"KL objective is only supported for MU/NSNMF, "
                f"got {self.algorithm}"
            )
        if self.mu_style == "jacobi":
            # post-canonicalization (beta=2/1 already folded to
            # FROBENIUS/KL): jacobi coupling is wired through the dense
            # Frobenius/KL update builders only
            if self.objective not in (Objective.FROBENIUS, Objective.KL):
                raise ValueError(
                    "mu_style='jacobi' supports the Frobenius and KL "
                    f"objectives only; got {self.objective}"
                )
            if self.alpha_confidence > 0.0 or self.mask == "observed":
                raise ValueError(
                    "mu_style='jacobi' does not support confidence "
                    "weighting or masked completion"
                )
        if self.objective is Objective.BETA:
            if self.algorithm is not Algorithm.MU:
                raise ValueError(
                    "the generalized beta objective runs the MU "
                    f"algorithm only (sklearn solver='mu'); got "
                    f"{self.algorithm}"
                )
        if self.alpha_confidence > 0.0 and (
            self.algorithm not in (Algorithm.MU, Algorithm.ALS)
            or self.objective is not Objective.FROBENIUS
        ):
            raise ValueError(
                "alpha_confidence (implicit-feedback weighting) is "
                "implemented for the MU algorithm (multiplicative) and "
                "the ALS algorithm (exact iALS solves) under the "
                f"Frobenius objective; got {self.algorithm}/"
                f"{self.objective} — running them unweighted silently "
                "would fit a different model than requested"
            )
        if (self.l1_w or self.l1_h) and self.algorithm is not Algorithm.HALS:
            raise ValueError(
                "l1_w/l1_h are HALS (coordinate descent) penalties; "
                f"got algorithm={self.algorithm}"
            )
        if self.algorithm is Algorithm.HALS and self.v_storage != "float32":
            raise ValueError(
                "HALS currently runs with v_storage='float32' (the "
                "column sweeps read exact numerators); use MU or the "
                "ALS family for low-precision V storage"
            )
        if (self.alpha_confidence > 0.0 and self.algorithm is Algorithm.ALS
                and self.v_storage != "float32"):
            raise ValueError(
                "weighted ALS (iALS) keeps V at full precision (the "
                "per-row Grams read exact values); v_storage low-"
                "precision storage is supported with the weighted MU "
                "algorithm instead"
            )
        if self.mask not in ("none", "observed"):
            raise ValueError(
                f"mask must be 'none' or 'observed', got {self.mask!r}"
            )
        if self.als_solver not in ("exact", "cg"):
            raise ValueError(
                f"als_solver must be 'exact' or 'cg', got "
                f"{self.als_solver!r}"
            )
        if self.cg_steps < 1:
            raise ValueError(f"cg_steps must be >= 1, got {self.cg_steps}")
        if self.als_solver == "cg" and not (
            self.algorithm is Algorithm.ALS
            and (self.alpha_confidence > 0.0 or self.mask == "observed")
        ):
            raise ValueError(
                "als_solver='cg' applies to the per-row batched solves "
                "of weighted ALS (alpha_confidence>0) or masked ALS "
                "(mask='observed'); the plain ALS family solves ONE "
                "r x r system, where the exact solve is already cheap"
            )
        if self.mask == "observed":
            ok = (
                self.algorithm is Algorithm.MU
                and self.objective in (Objective.FROBENIUS, Objective.KL)
            ) or (
                self.algorithm is Algorithm.ALS
                and self.objective is Objective.FROBENIUS
            )
            if not ok:
                raise ValueError(
                    "mask='observed' (matrix completion) is implemented "
                    "for MU under Frobenius/KL (scatter, ELL and grid "
                    "engines) and ALS under Frobenius (exact completion "
                    "ALS, scatter and grid engines); got "
                    f"{self.algorithm}/{self.objective}"
                )
            if self.alpha_confidence > 0.0:
                raise ValueError(
                    "mask='observed' and alpha_confidence are different "
                    "weighting models (0/1 mask vs 1+alpha*v); pick one"
                )
            if self.v_storage != "float32":
                raise ValueError(
                    "mask='observed' keeps v_storage='float32' (exact "
                    "observed values)"
                )
        if not 0.0 <= self.theta <= 1.0:
            raise ValueError(f"theta must be in [0, 1], got {self.theta}")
        for name in ("alpha_w", "alpha_h"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")


def resolve_dtype(name: str):
    """Factor/storage dtype for the drivers, mirroring the reference's
    float/double precision dispatch (SURVEY.md C1/C2: nmfgpu_compute
    dispatches {algorithm x float/double}).

    float32 and bfloat16 are native; float64 is supported end-to-end
    (every update rule is dtype-generic) but requires JAX x64 mode —
    without it JAX SILENTLY truncates to float32, which would turn the
    reference's double-precision contract into a quiet downgrade, so we
    raise instead. On the GPU float64 runs far below the float32 rate;
    it is intended for CPU verification runs and accuracy studies.
    """
    import jax
    import jax.numpy as jnp

    dt = jnp.dtype(name)
    if dt == jnp.dtype("float64") and not jax.config.jax_enable_x64:
        raise ValueError(
            "dtype='float64' requires JAX x64 mode (the reference's "
            "double-precision path): set JAX_ENABLE_X64=1 in the "
            "environment or jax.config.update('jax_enable_x64', True) "
            "at startup — without it JAX silently truncates every array "
            "to float32"
        )
    return dt
