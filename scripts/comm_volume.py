#!/usr/bin/env python
"""Communication volume of the sharded update, per device and iteration.

1. Compile the sharded per-iteration update (grid AND ring engines) on
   a virtual CPU mesh at p = 2/4/8 and extract EVERY collective op +
   payload shape from the optimized HLO — the compiler's own statement
   of what moves between devices each iteration.
2. Check the extracted bytes against the closed-form model of the
   design (psum'd factor numerators + r x r Grams on the 2-D grid;
   rotated blocks on the ring) and against the MPI-FAUN communication
   lower bound for NMF on a p-processor grid (Kannan–Ballard–Park,
   arxiv 1609.09154: Omega(r * sqrt(nm/p)) words/processor/iteration).
3. Price the per-device wire bytes at the graded cfg4 cell (200k x 100k
   per grid cell, nnz=10M/cell, r=256) over NVLink: 450 GB/s each way
   between any two H100s of a host. The step time that the efficiency
   column divides by is not measured yet; `chip_smoke.py --multi`
   times the sharded step on four cards.

Output: chiprun_out/comm_volume.json + a table on stdout. The pricing is
linear in the assumed link rate.
"""

from __future__ import annotations

import json
import os
import re
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nmftpu import NmfConfig  # noqa: E402
from nmftpu.data import synthetic_powerlaw_sparse  # noqa: E402
from nmftpu.parallel import make_grid_mesh  # noqa: E402
from nmftpu.parallel.driver import prepare_sharded  # noqa: E402

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4,
                "u32": 4, "s8": 1, "u8": 1, "pred": 1, "s64": 8,
                "u64": 8}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


def _shape_bytes(text: str) -> int:
    """Sum bytes over every dtype[dims] token in `text` (handles tuple
    result shapes)."""
    total = 0
    for dt, dims in re.findall(r"\b([a-z]+\d*)\[([\d,]*)\]", text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", line)
    if m:  # explicit form {{0,1},{2,3}}
        return len(m.group(1).split(","))
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=", line)
    if m:  # iota form [groups, group_size]<=[n]
        return int(m.group(2))
    return default


def extract_collectives(hlo: str, p: int):
    """Every collective instruction in the optimized HLO with its
    result payload bytes and group size. `-done` halves of async pairs
    are skipped (the `-start` carries the shape)."""
    out = []
    for line in hlo.splitlines():
        line = line.strip()
        m = re.search(
            r"= (.{0,200}?)\b(" + "|".join(_COLLECTIVES) + r")(-start)?\(",
            line,
        )
        if not m or re.search(r"(all-reduce|all-gather|reduce-scatter|"
                              r"collective-permute|all-to-all)-done", line):
            continue
        result_text = m.group(1)
        op = m.group(2)
        is_start = m.group(3) is not None
        payload = _shape_bytes(result_text)
        if payload == 0:
            continue
        if is_start and "," in result_text:
            # async `-start` forms return a (operand-alias, result)
            # tuple: summing every token would double-count; the true
            # payload is the LARGEST member (== result; for all-gather
            # the gathered output strictly exceeds the alias)
            tokens = re.findall(r"\b[a-z]+\d*\[[\d,]*\]", result_text)
            payload = max((_shape_bytes(t) for t in tokens),
                          default=payload)
        g = _group_size(line, p)
        out.append({"op": op, "bytes": payload, "group": g})
    return out


def wire_bytes_per_device(colls) -> float:
    """Ring-algorithm wire traffic per device for one execution of each
    collective (the standard cost model: all-reduce = 2*B*(g-1)/g,
    all-gather = B_out*(g-1)/g, reduce-scatter = B_out*(g-1),
    permute = B, all-to-all = B*(g-1)/g)."""
    total = 0.0
    for c in colls:
        b, g = c["bytes"], max(c["group"], 1)
        if g == 1:
            continue
        if c["op"] == "all-reduce":
            total += 2.0 * b * (g - 1) / g
        elif c["op"] == "all-gather":
            total += b * (g - 1) / g
        elif c["op"] == "reduce-scatter":
            total += b * (g - 1)
        elif c["op"] == "collective-permute":
            total += b
        elif c["op"] == "all-to-all":
            total += b * (g - 1) / g
    return total


def lower_update_hlo(engine: str, p: int, n, m, nnz, r, chunk=65536):
    """Compile ONE sharded update iteration (no init, no error check)
    and return its optimized HLO text plus the padded shard geometry."""
    mesh = make_grid_mesh(devices=jax.devices()[:p])
    sp = synthetic_powerlaw_sparse(n, m, nnz=nnz, seed=1)
    cfg = NmfConfig(rank=r, num_iterations=1, check_interval=1, seed=0)
    plan = prepare_sharded(sp, cfg, mesh=mesh, chunk=chunk,
                           engine=engine)
    ops = plan._ops(plan.config)
    pn, pm = plan.padded_shape
    rng = np.random.default_rng(0)
    W = jax.device_put(
        rng.uniform(0.1, 1.0, (pn, r)).astype(np.float32),
        plan.shardings["W"])
    H = jax.device_put(
        rng.uniform(0.1, 1.0, (r, pm)).astype(np.float32),
        plan.shardings["H"])
    aux = jax.jit(ops.make_aux)(plan.operand)

    step = jax.jit(lambda V, aux, W, H: ops.update(V, aux, W, H))
    compiled = step.lower(plan.operand, aux, W, H).compile()
    return compiled.as_text(), dict(mesh.shape), (pn, pm)


def model_ring_bytes(pm, r, p) -> float:
    """Closed-form wire bytes/device/iteration for the ring MU update,
    derived from the actual loop trip counts in parallel/ring.py:
    rotate_w's in-loop ppermute runs fori_loop(0, p) -> p executions
    (p-1 rotations + the home return through the same instruction);
    reduce_h's runs fori_loop(1, p) -> p-1, plus one separate
    home-delivery permute when p > 2. Total block permutes: 2p for
    p > 2, 2p-1 at p = 2; plus the two r x r Gram all-reduces, f32."""
    if p <= 1:
        return 0.0
    blk = r * (pm // p) * 4
    grams = 2 * (2 * r * r * 4 * (p - 1) / p)
    n_perm = 2 * p if p > 2 else 2 * p - 1
    return n_perm * blk + grams


def model_grid_bytes(pn, pm, r, pu, pi) -> float:
    """Closed-form wire bytes/device/iteration for the grid MU update:
    W-side numerator (pn/pu, r) + Gram (r, r) all-reduced over the
    items axis, H-side (r, pm/pi) + (r, r) over the users axis, f32,
    ring all-reduce factor 2(g-1)/g."""
    b = 0.0
    if pi > 1:
        b += 2 * ((pn // pu) * r + r * r) * 4 * (pi - 1) / pi
    if pu > 1:
        b += 2 * ((pm // pi) * r + r * r) * 4 * (pu - 1) / pu
    return b


def faun_lower_bound_bytes(n, m, r, p) -> float:
    """MPI-FAUN / Kannan–Ballard–Park bandwidth lower bound for one NMF
    iteration (computing both W^T V and V H^T on p processors):
    Omega(r * sqrt(nm/p)) words per processor, f32."""
    return r * (n * m / p) ** 0.5 * 4


def main():
    receipt = {"hlo_extraction": [], "projection": {}}
    n0, m0, r = 2048, 1024, 64
    nnz0 = 200_000

    print(f"{'engine':<9}{'p':>3}{'mesh':>8}{'colls':>7}"
          f"{'payload MB':>12}{'wire MB/dev':>13}{'model MB/dev':>14}"
          f"{'FAUN LB MB':>12}")
    for engine in ("scatter", "ring"):
        for p in (2, 4, 8):
            hlo, mesh_shape, (pn, pm) = lower_update_hlo(
                engine, p, n0 * p, m0, nnz0 * p, r)
            colls = extract_collectives(hlo, p)
            payload = sum(c["bytes"] for c in colls)
            wire = wire_bytes_per_device(colls)
            pu = mesh_shape.get("users", 1)
            pi = mesh_shape.get("items", 1)
            if engine == "scatter":
                model = model_grid_bytes(pn, pm, r, pu, pi)
            else:
                # ring permutes sit inside rotation fori_loops, so the
                # static extraction counts each instruction ONCE (a
                # per-loop-body count — trip counts are not visible in
                # the HLO text line). The extraction therefore
                # validates the instruction set + payload shapes; the
                # EXECUTED wire is the model column, derived from the
                # trip counts read directly from parallel/ring.py
                # (see model_ring_bytes).
                model = model_ring_bytes(pm, r, p)
            lb = faun_lower_bound_bytes(n0 * p, m0, r, p)
            by_op = {}
            for c in colls:
                by_op.setdefault(c["op"], {"count": 0, "bytes": 0})
                by_op[c["op"]]["count"] += 1
                by_op[c["op"]]["bytes"] += c["bytes"]
            row = {
                "engine": engine, "p": p, "mesh": mesh_shape,
                "padded_shape": [pn, pm], "rank": r,
                "collectives_by_op": by_op,
                "payload_bytes_total": payload,
                "wire_bytes_per_device": round(wire),
                "wire_note": ("grid: static = executed (collectives "
                              "outside loops)" if engine == "scatter"
                              else "ring: static per-loop-body count "
                                   "(validates instruction set + "
                                   "payload shapes); executed wire = "
                                   "the model column, from the trip "
                                   "counts in parallel/ring.py"),
                "model_wire_bytes_per_device": round(model),
                "faun_lower_bound_bytes_per_proc": round(lb),
            }
            receipt["hlo_extraction"].append(row)
            print(f"{engine:<9}{p:>3}{str(tuple(mesh_shape.values())):>8}"
                  f"{len(colls):>7}{payload / 1e6:>12.2f}"
                  f"{wire / 1e6:>13.2f}"
                  f"{(model or 0) / 1e6:>14.2f}{lb / 1e6:>12.2f}")

    # ---- NVLink pricing at the graded cfg4 cell -------------------------
    # Weak scaling: a pu x pi grid holds an (200k*pu) x (100k*pi) global
    # problem; per-device wire bytes from the HLO-validated grid model.
    # NVLink joins every card of a host to every other at 450 GB/s each
    # way (NVIDIA's H100 SXM data sheet), so the mesh shape does not
    # change the rate. The single-card step time is not measured here.
    n_cell, m_cell, r4 = 200_000, 100_000, 256
    nvlink = 450e9
    proj = {}
    for p, (pu, pi) in {2: (1, 2), 4: (2, 2), 8: (2, 4)}.items():
        wire = model_grid_bytes(n_cell * pu, m_cell * pi, r4, pu, pi)
        lb = faun_lower_bound_bytes(n_cell * pu * 1, m_cell * pi, r4, p)
        proj[p] = {"mesh": [pu, pi],
                   "wire_bytes_per_device": round(wire),
                   "faun_lb_bytes_per_proc": round(lb),
                   "x_over_faun_lb": round(wire / lb, 2),
                   "t_comm_ms_nvlink": round(wire / nvlink * 1e3, 3),
                   "eff_no_overlap": "not measured"}
    receipt["projection"] = {
        "per_device_cell": [n_cell, m_cell],
        "rank": r4,
        "single_card_step_ms": "not measured",
        "link_bytes_per_s_each_way": nvlink,
        "weak_scaling": proj,
    }

    print("\nNVLink pricing at the cfg4 cell (200k x 100k / device, "
          "r=256):")
    print(f"{'p':>4}{'mesh':>9}{'wire MB/dev':>13}{'xLB':>6}"
          f"{'NVLink ms':>11}")
    for p, e in proj.items():
        print(f"{p:>4}{str(tuple(e['mesh'])):>9}"
              f"{e['wire_bytes_per_device'] / 1e6:>13.1f}"
              f"{e['x_over_faun_lb']:>6.2f}"
              f"{e['t_comm_ms_nvlink']:>11.3f}")

    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "comm_volume.json")
    with open(out, "w") as f:
        json.dump(receipt, f, indent=1)
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
