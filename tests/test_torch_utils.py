"""The port's utilities: timing chains, the device f64 oracle, profiling,
the build directory's override, and the training example.

``device_full_check`` is held to ``golden_spmm_exact`` and must catch a
single poisoned element anywhere in C (mirroring
``tests/test_device_verify.py``); here it runs on CPU tensors.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import importlib.util
import json
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu_torch.runtime import build
from sextans_tpu_torch.utils import cache
from sextans_tpu_torch.utils.device_verify import device_full_check
from sextans_tpu_torch.utils.profiling import annotate, trace
from sextans_tpu_torch.utils.timing import time_chained, time_repeat_chained

REPO = Path(__file__).resolve().parent.parent


# ---- timing ----

def test_time_chained_is_dependency_chain():
    calls = []

    def step(c):
        calls.append(time.perf_counter())
        return c + 1.0

    c0 = torch.zeros((4, 4))
    secs = time_chained(step, c0, rp_time=5, warmup=1)
    assert secs >= 0
    assert len(calls) == 6  # 1 warmup + 5 timed


def test_time_chained_restarts_from_c0():
    seen = []

    def step(c):
        seen.append(float(c))
        return c + 1

    time_chained(step, torch.tensor(0.0), rp_time=3, warmup=2)
    assert seen == [0.0, 1.0, 0.0, 1.0, 2.0]


def test_time_repeat_chained_runs():
    coo = tx.COOMatrix.random(50, 60, 300, seed=1)
    plan = tx.plan(tx.pack(coo), 16, device="cpu")
    rng = np.random.default_rng(2)
    b = torch.as_tensor(rng.standard_normal((60, 16)).astype(np.float32))
    c0 = torch.as_tensor(rng.standard_normal((50, 16)).astype(np.float32))
    secs, info = time_repeat_chained(plan, b, 0.5, 0.5, c0, times=3, detail=True)
    assert secs > 0
    assert info["method"] in ("chained-differential", "chained-amortized")
    assert info["times"] == 3 and info["wall_2T_s"] > 0 and info["device"] == "cpu"
    assert time_repeat_chained(plan, b, 0.5, 0.5, c0, times=2) > 0


# ---- device_full_check on CPU tensors ----

@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    m, k, n = 1000, 700, 96
    coo = tx.COOMatrix.random(m, k, 24000, seed=1)
    csr = tx.CSRMatrix.from_coo(coo)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    exact = tx.golden_spmm_exact(csr, b, 0.85, -2.06, c)
    return csr, b, c, exact


def test_clean_result_near_zero_error(problem):
    csr, b, c, exact = problem
    res = device_full_check(torch.as_tensor(exact.astype(np.float32)), csr, b, 0.85, -2.06,
                            c, block_rows=256, edge_chunk=2048)
    # f32 rounding of the exact result is the only error source
    assert res["max_abs_vs_f64"] < 1e-4
    assert res["blocks"] == 4  # ceil(1000 / 256) — ragged tail included
    assert res["c_max_abs"] == pytest.approx(np.abs(exact).max(), rel=1e-6)
    # its error is the f32 rounding's, element for element
    want = float(np.abs(exact.astype(np.float32).astype(np.float64) - exact).max())
    assert res["max_abs_vs_f64"] == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("poison_row", [0, 777, 999])
def test_catches_single_poisoned_element(problem, poison_row):
    csr, b, c, exact = problem
    bad = exact.astype(np.float32).copy()
    bad[poison_row, 5] += np.float32(3e-3)
    res = device_full_check(torch.as_tensor(bad), csr, b, 0.85, -2.06, c,
                            block_rows=256, edge_chunk=2048)
    assert res["max_abs_vs_f64"] > 2.5e-3


def test_a_nan_is_caught(problem):
    csr, b, c, exact = problem
    bad = exact.astype(np.float32).copy()
    bad[300, 1] = np.nan
    res = device_full_check(torch.as_tensor(bad), csr, b, 0.85, -2.06, c,
                            block_rows=256, edge_chunk=2048)
    assert np.isnan(res["max_abs_vs_f64"])


def test_beta_zero_and_tiny_edge_cases():
    coo = tx.COOMatrix((5, 3), np.array([2]), np.array([1]), np.array([2.0], np.float32))
    csr = tx.CSRMatrix.from_coo(coo)
    b = np.ones((3, 8), np.float32)
    want = tx.golden_spmm_exact(csr, b, 1.0, 0.0, None)
    res = device_full_check(torch.as_tensor(want.astype(np.float32)), csr,
                            torch.as_tensor(b), 1.0, 0.0, None, block_rows=4, edge_chunk=8)
    assert res["max_abs_vs_f64"] == 0.0
    assert res["c_max_abs"] == 2.0
    assert res["blocks"] == 2


def test_shape_mismatch_rejected(problem):
    csr, b, _, _ = problem
    with pytest.raises(ValueError, match="got must be"):
        device_full_check(torch.zeros((10, 10)), csr, b, 1.0, 0.0, None)


# ---- profiling ----

def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "tr") as prof:
        with annotate("sextans.step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "sextans.step" for e in events)
    assert any(e.key == "sextans.step" for e in prof.key_averages())


# ---- the build directory ----

def _fake_build(monkeypatch, tmp_path):
    """``build_kernels`` with a fake nvcc that writes its outputs and a fake
    loader: returns the library path it loaded."""
    loaded = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            if "-o" in cmd:
                Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return "", ""

    def fake_cdll(path):
        loaded.append(Path(path))
        return types.SimpleNamespace(**{name: types.SimpleNamespace()
                                        for name in build._SIGNATURES})

    monkeypatch.setattr(build.shutil, "which", lambda name: "/nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "default")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    build.build_kernels.cache_clear()
    try:
        build.build_kernels()
    finally:
        build.build_kernels.cache_clear()
    return loaded[0]


def test_cache_dir_moves_the_build_directory(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path / "cache"))
    lib = _fake_build(monkeypatch, tmp_path)
    assert lib.parent == tmp_path / "cache" / "sextans_tpu_torch"
    assert lib.name == f"libsextans_kernels_{build._source_hash()}.so" and lib.is_file()
    assert not (tmp_path / "default").exists()


def test_build_directory_default(monkeypatch, tmp_path):
    assert build.BUILD_DIR == REPO / "sextans_tpu_torch" / "build"
    monkeypatch.delenv(cache.CACHE_ENV, raising=False)
    assert _fake_build(monkeypatch, tmp_path).parent == tmp_path / "default"
    monkeypatch.setenv(cache.CACHE_ENV, "")
    assert cache.cache_dir(tmp_path / "x") == tmp_path / "x"


# ---- the training example ----

def test_train_sparse_example_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "train_sparse_torch", REPO / "examples" / "train_sparse_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    final = example.main(["--device", "cpu"])
    assert final < 1e-4
    out = capsys.readouterr().out
    assert "step   0" in out and "OK" in out
