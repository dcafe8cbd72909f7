"""Parallelism layer (SURVEY.md §2.9, §5.7–5.8): the capability the
single-GPU reference lacked entirely.

* 2-D logical device mesh ('users', 'items'): W row-sharded over the users
  axis, H column-sharded over the items axis, V's nonzeros tiled over both.
* One `shard_map` per iteration: local SpMM/SDDMM primitives on each tile,
  tiny r x r Grams and (r, block) numerators reduced with `psum` over the
  matching mesh axis — the MPI-FAUN 2-D-grid communication pattern, carried
  by XLA collectives (NCCL on the GPU) instead of MPI.
* Sharded retrieval: per-item-shard blocked top-k, then an all-gather merge.
"""

from nmftpu.parallel.mesh import (
    AXIS_ITEMS,
    AXIS_USERS,
    factor_shardings,
    make_grid_mesh,
)
from nmftpu.parallel.sharded_coo import ShardedCOO, partition_sparse
from nmftpu.parallel.driver import (
    ShardedPlan,
    compute_sharded,
    prepare_sharded,
)
from nmftpu.parallel.retrieval_sharded import (
    certify_topk_sharded,
    topk_mips_sharded,
)
from nmftpu.parallel import ring

__all__ = [
    "AXIS_ITEMS",
    "AXIS_USERS",
    "ShardedCOO",
    "ShardedPlan",
    "compute_sharded",
    "prepare_sharded",
    "factor_shardings",
    "make_grid_mesh",
    "partition_sparse",
    "ring",
    "certify_topk_sharded",
    "topk_mips_sharded",
]
