"""Robustness tests (SURVEY.md §5.2–5.3): NaN-debugging mode, fault
injection with restart-based recovery."""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from nmftpu import Initialization, NmfConfig
from nmftpu import checkpoint as ckpt
from nmftpu.driver import compute


def _problem(rng, n=30, m=24, r=3):
    W = rng.uniform(0.1, 1.0, (n, r)).astype(np.float32)
    H = rng.uniform(0.1, 1.0, (r, m)).astype(np.float32)
    return (W @ H).astype(np.float32)


def test_no_nans_under_debug_nans(rng):
    """The whole MU pipeline must be NaN-free under jax_debug_nans —
    including zero rows/columns in V (worst case for the eps guards)."""
    V = _problem(rng)
    V[3, :] = 0.0
    V[:, 5] = 0.0
    jax.config.update("jax_debug_nans", True)
    try:
        res = compute(V, NmfConfig(rank=3, num_iterations=30))
        assert np.isfinite(res.frobenius_error)
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.slow
def test_kill_one_host_then_restart_from_checkpoint(tmp_path, rng):
    """Fault injection (SURVEY.md §5.3): in a 2-process run, killing one
    host fails the job fast; recovery = restart from the last checkpoint.
    Here the kill phase uses the multihost worker; the restart phase
    resumes single-host from a checkpoint written before the 'failure'."""
    V = _problem(rng, 40, 30, 4)
    base = NmfConfig(
        rank=4, num_iterations=40,
        init_method=Initialization.COPY_EXISTING,
    )
    W0 = rng.uniform(0.1, 1.0, (40, 4)).astype(np.float32)
    H0 = rng.uniform(0.1, 1.0, (4, 30)).astype(np.float32)

    # phase 1: run half, checkpoint (simulates periodic checkpointing)
    half = dataclasses.replace(base, num_iterations=20)
    r1 = compute(V, half, W0=W0, H0=H0)
    ckpt.save(str(tmp_path / "ck"), np.asarray(r1.W), np.asarray(r1.H),
              iteration=20, config=base)

    # phase 2: multihost job where one worker dies -> surviving worker
    # must NOT hang forever; we emulate the failure detector by timeout
    worker = os.path.join(os.path.dirname(__file__),
                          "multihost_worker.py")
    s = socket.socket(); s.bind(("localhost", 0))
    coord = f"localhost:{s.getsockname()[1]}"; s.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["NMFTPU_INIT_TIMEOUT"] = "30"  # fail fast when the peer is gone
    p0 = subprocess.Popen(
        [sys.executable, worker, coord, "2", "0"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env,
    )
    p1 = subprocess.Popen(
        [sys.executable, worker, coord, "2", "1"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env,
    )
    p1.kill()  # inject failure: host 1 dies during bring-up
    try:
        p0.wait(timeout=120)  # surviving host must exit (fail-fast), not hang
        assert p0.returncode != 0
    except subprocess.TimeoutExpired:
        p0.kill()
        pytest.fail("surviving host hung after peer failure")
    finally:
        if p0.poll() is None:
            p0.kill()

    # phase 3: restart from checkpoint completes the job
    resumed = ckpt.resume(str(tmp_path / "ck"), V, base)
    full = compute(V, base, W0=W0, H0=H0)
    np.testing.assert_allclose(
        resumed.frobenius_error, full.frobenius_error, rtol=1e-4
    )
