"""Pure-jnp linear-algebra layer: the semantic reference implementation of
every update rule and error metric (SURVEY.md L1/C3–C7, C9, C13, C14).

These functions are shape-polymorphic, jit-friendly, and used three ways:
1. directly, on the CPU and the GPU, as the default compute path;
2. as the oracle the engines and kernels are tested against;
3. as the per-shard local math inside `shard_map`-based sharded updates.
"""

from nmftpu.linalg.dense import (
    acls_update,
    ahcls_update,
    als_update,
    frobenius_error,
    frobenius_error_sq,
    gdcls_update,
    kl_error,
    mu_update_frobenius,
    mu_update_kl,
    nsnmf_smoothing_matrix,
    rmsd,
)

__all__ = [
    "acls_update",
    "ahcls_update",
    "als_update",
    "frobenius_error",
    "frobenius_error_sq",
    "gdcls_update",
    "kl_error",
    "mu_update_frobenius",
    "mu_update_kl",
    "nsnmf_smoothing_matrix",
    "rmsd",
]
