"""Device mesh construction and canonical shardings.

The logical mesh has two axes:
  'users' — W (n, r) is row-sharded here; reductions forming H-side
            numerators and W^T W ride psum over this axis;
  'items' — H (r, m) is column-sharded here; dual reductions likewise.

On the GPU every card of a host reaches every other over NVLink at the
same rate, so the mesh shape follows the algorithm alone; across hosts
the same program runs via jax.distributed.initialize().
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_USERS = "users"
AXIS_ITEMS = "items"


def _squarest_grid(ndev: int) -> tuple[int, int]:
    """Factor ndev into the most-square (pu, pi) grid."""
    best = (1, ndev)
    for pu in range(1, int(math.isqrt(ndev)) + 1):
        if ndev % pu == 0:
            best = (pu, ndev // pu)
    return best


def make_grid_mesh(
    mesh_shape: tuple[int, int] | None = None,
    devices=None,
) -> Mesh:
    """Build the 2-D ('users', 'items') mesh over the given devices
    (default: all). With no shape given, factors the device count into the
    squarest grid — on 1 device this degrades to a (1, 1) mesh and every
    collective becomes a no-op."""
    if devices is None:
        devices = jax.devices()
    ndev = len(devices)
    if mesh_shape is None:
        mesh_shape = _squarest_grid(ndev)
    pu, pi = mesh_shape
    if pu * pi != ndev:
        raise ValueError(
            f"mesh shape {mesh_shape} does not cover {ndev} devices"
        )
    arr = np.asarray(devices).reshape(pu, pi)
    return Mesh(arr, (AXIS_USERS, AXIS_ITEMS))


def factor_shardings(mesh: Mesh):
    """Canonical NamedShardings for the factorization operands."""
    return {
        "W": NamedSharding(mesh, P(AXIS_USERS, None)),
        "H": NamedSharding(mesh, P(None, AXIS_ITEMS)),
        "V": NamedSharding(mesh, P(AXIS_USERS, AXIS_ITEMS)),
        "tile": NamedSharding(mesh, P(AXIS_USERS, AXIS_ITEMS, None)),
        "replicated": NamedSharding(mesh, P()),
    }
