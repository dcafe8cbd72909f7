"""Multi-host bring-up (SURVEY.md §5.8, §3.1).

The reference is single-process; its `nmfgpu_initialize` maps here to
`initialize_distributed()`: every host runs the same program, JAX's
distributed runtime wires the hosts into one global device set, and the
2-D ('users','items') mesh simply
spans all global devices — the shard_map update code is unchanged.

Data placement across processes uses `jax.make_array_from_callback`: each
host materializes only the tiles its local devices own (see
`partition_sparse`), so no host ever holds the full nonzero set.
"""

from __future__ import annotations

import os

import jax


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int | None = None,
) -> None:
    """Initialize JAX's multi-host runtime (idempotent).

    With no arguments, relies on the environment (a cluster JAX can
    detect, or the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID variables; a plain GPU host has neither, so pass
    the coordinator address, process count and id there). Call before
    any other JAX operation on every host.
    """
    kwargs = {}
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if process_id is not None:
        kwargs["process_id"] = process_id
    if initialization_timeout is None and "NMFTPU_INIT_TIMEOUT" in os.environ:
        initialization_timeout = int(os.environ["NMFTPU_INIT_TIMEOUT"])
    if initialization_timeout is not None:
        kwargs["initialization_timeout"] = initialization_timeout
    # honor the documented idempotency: a second call (bring-up script +
    # library both initializing) must be a no-op, not a RuntimeError
    state = getattr(jax.distributed, "global_state", None)
    if state is not None and getattr(state, "client", None) is not None:
        return
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already" not in str(e).lower():
            raise


def is_multiprocess() -> bool:
    return jax.process_count() > 1
