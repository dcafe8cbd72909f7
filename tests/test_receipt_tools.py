"""Unit tests for the receipt tooling itself: the comm-volume HLO
collective parser (scripts/comm_volume.py's extraction layer) and the sharded
test-gate's partitioner. A receipt is only as good as its parser."""

import os
import sys

import numpy as np

SCRIPTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scripts")
sys.path.insert(0, SCRIPTS)


def test_shape_bytes_tokens():
    from comm_volume import _shape_bytes

    assert _shape_bytes("f32[8,32]{1,0}") == 8 * 32 * 4
    assert _shape_bytes("bf16[128]") == 256
    assert _shape_bytes("(f32[4,4], s32[4,4])") == 2 * 16 * 4
    assert _shape_bytes("pred[16]") == 16
    assert _shape_bytes("token[]") == 0  # unknown dtype ignored
    assert _shape_bytes("f32[]") == 4    # scalar


def test_group_size_forms():
    from comm_volume import _group_size

    assert _group_size("all-reduce(...), replica_groups={{0,1},{2,3}}",
                       8) == 2
    assert _group_size("all-gather(...), replica_groups=[2,4]<=[8]",
                       8) == 4
    assert _group_size("no groups here", 8) == 8  # default


def test_extract_collectives_sync_and_async():
    from comm_volume import extract_collectives

    hlo = "\n".join([
        "%ar = f32[8,32]{1,0} all-reduce(f32[8,32]{1,0} %x), "
        "replica_groups={{0,1,2,3}}, to_apply=%add",
        # async pair: -start counts its LARGEST tuple member once,
        # -done is skipped
        "%ags = (f32[8,32]{1,0}, f32[32,32]{1,0}) "
        "all-gather-start(f32[8,32]{1,0} %y), replica_groups=[2,4]<=[8]",
        "%agd = f32[32,32]{1,0} all-gather-done((f32[8,32], "
        "f32[32,32]) %ags)",
        "%cp = f32[16,16]{1,0} collective-permute(f32[16,16]{1,0} %z), "
        "source_target_pairs={{0,1},{1,0}}",
        "%irrelevant = f32[4,4] add(f32[4,4] %a, f32[4,4] %b)",
    ])
    colls = extract_collectives(hlo, p=8)
    ops = sorted(c["op"] for c in colls)
    assert ops == ["all-gather", "all-reduce", "collective-permute"]
    by_op = {c["op"]: c for c in colls}
    assert by_op["all-reduce"]["bytes"] == 8 * 32 * 4
    assert by_op["all-reduce"]["group"] == 4
    # async start: the larger tuple member only (the gathered result)
    assert by_op["all-gather"]["bytes"] == 32 * 32 * 4
    assert by_op["all-gather"]["group"] == 4
    assert by_op["collective-permute"]["bytes"] == 16 * 16 * 4


def test_wire_model():
    from comm_volume import wire_bytes_per_device

    colls = [
        {"op": "all-reduce", "bytes": 1000, "group": 4},
        {"op": "all-gather", "bytes": 800, "group": 8},
        {"op": "collective-permute", "bytes": 500, "group": 8},
        {"op": "all-reduce", "bytes": 100, "group": 1},  # no-op group
    ]
    got = wire_bytes_per_device(colls)
    want = 2 * 1000 * 3 / 4 + 800 * 7 / 8 + 500
    assert abs(got - want) < 1e-9


def test_ring_model_matches_extracted_bytes():
    """The ring closed-form must reproduce the exact per-instruction
    byte sizes the HLO of the ring step carries (blk and gram terms)."""
    from comm_volume import model_ring_bytes

    r = 64
    # p=2: (2p-1)=3 block rotations + gram psums
    blk = lambda pm, p: r * (pm // p) * 4
    grams = lambda p: 2 * (2 * r * r * 4 * (p - 1) / p)
    assert model_ring_bytes(1024, r, 2) == 3 * blk(1024, 2) + grams(2)
    assert model_ring_bytes(1024, r, 8) == 16 * blk(1024, 8) + grams(8)


def test_gate_partition_covers_everything():
    from run_tests import TESTS, partition

    files = sorted(
        f for f in os.listdir(TESTS)
        if f.startswith("test_") and f.endswith(".py"))
    for n in (1, 2, 3, 5):
        shards = partition(files, n)
        flat = sorted(f for s in shards for f in s)
        assert flat == files, n          # every file exactly once
        assert len(shards) <= n
        sizes = [sum(os.path.getsize(os.path.join(TESTS, f))
                     for f in s) for s in shards]
        if n > 1 and len(sizes) > 1:
            # greedy balance: no shard more than ~3x the smallest
            assert max(sizes) <= 3 * max(min(sizes), 1), sizes
