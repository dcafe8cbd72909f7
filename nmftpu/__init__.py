"""nmftpu — non-negative matrix factorization recommender-embedding engine in JAX.

A brand-new JAX/XLA/Pallas implementation with the capabilities of the
``razorx89/nmfgpu`` CUDA library (see SURVEY.md for the reference analysis;
the reference mount was empty at build time, so component IDs C1..C19 from
SURVEY.md §2 are cited instead of reference file:line):

* the reference's six NMF algorithms — multiplicative updates (Frobenius
  + KL objectives), ALS, ACLS, AHCLS, GDCLS, nsNMF     (SURVEY.md C3–C7)
  — plus HALS (sklearn's 'cd', f64-roundoff parity) and iALS (implicit-weighted
  exact solves), beyond the reference
* six initialization strategies incl. jitted k-means    (SURVEY.md C8)
* dense and sparse (CSR/CSC/COO) interaction matrices   (SURVEY.md C10–C11)
* multi-run restarts, threshold convergence without host
  round-trips (``lax.while_loop`` carry)               (SURVEY.md C2, C9)
* 2-D (users, items) device-mesh sharding with GSPMD
  collectives, ring-SpMM                               (SURVEY.md §2.9, §5.8)
* retrieval: factors as sharded embedding tables + top-k
  MIPS, recall@k evaluation                            (BASELINE.json configs)
"""

from nmftpu.config import (
    Algorithm,
    Initialization,
    MatrixFormat,
    NmfConfig,
    Objective,
    ThresholdType,
)
from nmftpu.driver import NmfResult, compute
from nmftpu.api import nmf

__version__ = "0.1.0"

_LAZY = {
    "compute_sparse": ("nmftpu.sparse_ops", "compute_sparse"),
    "prepare_sparse": ("nmftpu.sparse_ops", "prepare_sparse"),
    "SparsePlan": ("nmftpu.sparse_ops", "SparsePlan"),
    "compute_sharded": ("nmftpu.parallel", "compute_sharded"),
    "prepare_sharded": ("nmftpu.parallel", "prepare_sharded"),
    "ShardedPlan": ("nmftpu.parallel", "ShardedPlan"),
    "Recommender": ("nmftpu.serving", "Recommender"),
    "recall_at_k": ("nmftpu.retrieval", "recall_at_k"),
    "transform": ("nmftpu.foldin", "transform"),
    "TransformResult": ("nmftpu.foldin", "TransformResult"),
    "NMF": ("nmftpu.sklearn_api", "NMF"),
    "MiniBatchNMF": ("nmftpu.sklearn_api", "MiniBatchNMF"),
    "OnlineNMF": ("nmftpu.minibatch", "OnlineNMF"),
    "minibatch_fit": ("nmftpu.minibatch", "minibatch_fit"),
    "rank_selection": ("nmftpu.model_selection", "rank_selection"),
    "compute_batched": ("nmftpu.batched", "compute_batched"),
    "BatchedNmfResult": ("nmftpu.batched", "BatchedNmfResult"),
    "non_negative_factorization": (
        "nmftpu.sklearn_api", "non_negative_factorization"
    ),
}


def __getattr__(name):
    """Lazy re-exports of the heavier subsystem entry points."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'nmftpu' has no attribute {name!r}")

__all__ = [
    "Algorithm",
    "Initialization",
    "MatrixFormat",
    "NmfConfig",
    "NmfResult",
    "Objective",
    "ThresholdType",
    "compute",
    "nmf",
    "__version__",
]
