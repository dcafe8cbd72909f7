"""chip_smoke.py rehearsed on the CPU at tiny sizes: every phase function
and reference comparison, the four-card phase on virtual devices, and
the refusal to report a result without a GPU."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture
def rep():
    return chip_smoke.Report("test card, 0 W")


def test_refuses_without_gpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "needs a GPU" in str(exc.value.code)
    out = capsys.readouterr().out
    assert '"ok"' not in out
    assert out.startswith("card: ")


def test_check_raises_outside_tolerance(rep, capsys):
    rep.check("p", "inside", 0.5, 1.0, "why")
    with pytest.raises(chip_smoke.SmokeFailure):
        rep.check("p", "outside", 2.0, 1.0, "why")
    with pytest.raises(chip_smoke.SmokeFailure):
        rep.check("p", "not finite", float("nan"), 1.0, "why")
    out = capsys.readouterr().out
    assert "FAILED" in out and "| test card, 0 W" in out


def test_make_ratings_exact_nnz_on_half_star_grid():
    sp = chip_smoke.make_ratings(500, 300, 20_000, seed=0)
    assert sp.nnz == 20_000
    keys = sp.row.astype(np.int64) * 300 + sp.col
    assert np.unique(keys).size == 20_000
    assert set(np.unique(sp.data)) <= set(chip_smoke.HALF_STARS.tolist())


def test_phase_train_tiny(rep, capsys):
    chip_smoke.phase_train(rep, n=300, m=200, nnz=4000, rank=8, iters=5,
                           cap=60, panel=64)
    out = capsys.readouterr().out
    assert "engine densified" in out
    assert out.count(": ok") == 4
    assert "under HIGHEST" in out


def test_phase_dense_tiny(rep, capsys):
    chip_smoke.phase_dense(rep, n=64, rank=16, iters=5)
    out = capsys.readouterr().out
    assert out.count(": ok") == 3


def test_phase_serve_tiny(rep, capsys):
    chip_smoke.phase_serve(rep, m=8192, rank=16, b=16, k=10, seen_per=10,
                           n_users=32, ref_block=1024)
    out = capsys.readouterr().out
    assert "reservoir (plain XLA)" in out
    assert out.count(": ok") == 2 * 6


def test_phase_multi_on_virtual_devices(rep, capsys):
    """The --multi phase on four of the test harness's virtual CPU
    devices: meshes, shard placement and the one-device comparison."""
    chip_smoke.phase_multi(rep, n_per=60, m_per=40, nnz_per=600, rank=8,
                           iters=3, serve_m=8192, b=8, k=5)
    out = capsys.readouterr().out
    assert out.count(": ok") == 2 * 2 + 2
    assert "TFRT_CPU_0" in out and "TFRT_CPU_3" in out
