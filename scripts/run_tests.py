#!/usr/bin/env python
"""THE test gate: the full suite, sharded across pytest subprocesses.

Why not one ``pytest tests/`` process: the suite compiles ~500+ distinct
XLA CPU programs, and a single process reproducibly dies inside XLA's
``backend_compile_and_load`` near the end of the run (SIGSEGV/SIGABRT
mid-compile in whatever file happens to be last; every crashing test
passes in isolation, and either half of the suite passes on its own —
cumulative per-process compiler exhaustion, not a bug in any one test).
The gate therefore partitions ``tests/`` BY FILE into a few pytest
subprocesses, each comfortably under the cliff, and aggregates results.

Usage::

    python scripts/run_tests.py              # 3 shards, sequential
    python scripts/run_tests.py -n 4         # more shards
    python scripts/run_tests.py -k serving   # extra args pass through

Exit code is nonzero iff any shard fails. The per-shard and total
pass/fail counts are printed at the end.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def partition(files: list[str], n: int) -> list[list[str]]:
    """Greedy size-balanced partition (file size ~ test weight is crude
    but keeps shard wall-clock within ~2x of even)."""
    sized = sorted(
        ((os.path.getsize(os.path.join(TESTS, f)), f) for f in files),
        reverse=True,
    )
    shards: list[list[str]] = [[] for _ in range(n)]
    loads = [0] * n
    for sz, f in sized:
        i = loads.index(min(loads))
        shards[i].append(f)
        loads[i] += sz
    return [sorted(s) for s in shards if s]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--shards", type=int, default=3,
                    help="number of pytest subprocesses (default 3)")
    args, extra = ap.parse_known_args()

    files = sorted(
        f for f in os.listdir(TESTS)
        if f.startswith("test_") and f.endswith(".py")
    )
    shards = partition(files, args.shards)

    totals = {"passed": 0, "failed": 0, "errors": 0, "skipped": 0}
    rcs = []
    t0 = time.time()
    for idx, shard in enumerate(shards):
        print(f"== shard {idx + 1}/{len(shards)}: {len(shard)} files ==",
              flush=True)
        cmd = [sys.executable, "-m", "pytest", "-q",
               *extra, *(os.path.join("tests", f) for f in shard)]
        t = time.time()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                              text=True)
        out = proc.stdout + proc.stderr
        tail = out.strip().splitlines()[-15:]
        print("\n".join(tail), flush=True)
        print(f"-- shard {idx + 1} rc={proc.returncode} "
              f"({time.time() - t:.0f}s)", flush=True)
        rcs.append(proc.returncode)
        for key, pat in (("passed", r"(\d+) passed"),
                         ("failed", r"(\d+) failed"),
                         ("errors", r"(\d+) error"),
                         ("skipped", r"(\d+) skipped")):
            m = re.search(pat, out)
            if m:
                totals[key] += int(m.group(1))

    ok = all(rc == 0 for rc in rcs)
    print(f"\n=== GATE {'GREEN' if ok else 'RED'}: "
          f"{totals['passed']} passed, {totals['failed']} failed, "
          f"{totals['errors']} errors, {totals['skipped']} skipped "
          f"across {len(shards)} shards in {time.time() - t0:.0f}s ===")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
