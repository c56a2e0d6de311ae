"""Guards of the PyTorch port: it never imports JAX, its kernels build only
with nvcc and never fall back, and what it does not run yet raises."""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import ctypes
import importlib.util
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu_torch.runtime import build

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "sextans_tpu_torch"


def test_import_loads_no_jax():
    code = (
        "import sys, sextans_tpu_torch, sextans_tpu_torch.cli, sextans_tpu_torch.ops.hybrid\n"
        "import sextans_tpu_torch.utils.timing, sextans_tpu_torch.utils.matrices\n"
        "import sextans_tpu_torch.probes.dma_gather, sextans_tpu_torch.probes.ell_issue\n"
        "import sextans_tpu_torch.ops.autodiff, sextans_tpu_torch.format.slots\n"
        "import sextans_tpu_torch.utils.device_verify, sextans_tpu_torch.utils.profiling\n"
        "import sextans_tpu_torch.utils.cache\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sextans_tpu', 'triton'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_no_file_of_the_package_imports_jax():
    files = list(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py",
                                           REPO / "examples" / "train_sparse_torch.py"]
    assert len(files) > 10
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|sextans_tpu|benchmarks)\b", re.M)
    for path in files:
        assert not banned.search(path.read_text()), path


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "no_cuda_either")
    build.build_kernels.cache_clear()
    yield
    build.build_kernels.cache_clear()


def test_build_without_nvcc_raises_naming_nvcc(no_nvcc):
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_kernels()


def test_failed_compile_raises_and_leaves_no_library(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such device' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.build_kernels.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no such device"):
            build.build_kernels()
    finally:
        build.build_kernels.cache_clear()
    assert list((tmp_path / "build").iterdir()) == []


def test_build_flags_target_hopper_and_hash_sources():
    assert "arch=compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    assert {p.name for p in build._sources()} == {
        "spmm_block.cu", "spmm_block_precise1.cu", "spmm_block_precise2.cu",
        "spmm_slab.cu", "spmm_edge.cu", "spmm_ell.cu", "spmm_dia.cu", "df32_probe.cu",
        "gather_probe.cu", "sddmm.cu", "hybrid_hub.cu"}
    assert build._source_hash() == build._source_hash()
    # the headers are hashed with the sources, so editing one rebuilds
    for header in ("df32.cuh", "spmm_block.cuh", "async_copy.cuh"):
        assert (build.CSRC_DIR / header).is_file()
    # every pointer and the stream are c_void_p, so none is cut to 32 bits
    pointers = {"spmm_block_launch": 8, "spmm_slab_launch": 9,
                "spmm_slab_skinny_launch": 7, "spmm_edge_launch": 10,
                "spmm_ell_launch": 12, "spmm_dia_launch": 6, "spmm_dia_skinny_launch": 6,
                "spmm_dia_entry_launch": 9,
                "df32_probe_pairs": 6, "df32_probe_chain": 3,
                "dma_gather_launch": 4, "ell_issue_launch": 4, "sddmm_tile_launch": 9,
                "hybrid_hub_launch": 7}
    # alpha and beta: the SpMM kernels take both, the hub pass alpha alone (it
    # adds into the DIA kernel's output), the probes and the SDDMM neither
    probes = {"df32_probe_pairs", "df32_probe_chain", "dma_gather_launch", "ell_issue_launch",
              "sddmm_tile_launch"}
    entries = [name for name in build._SIGNATURES if name != "sx_error_string"]
    assert sorted(entries) == sorted(pointers)
    for name in entries:
        argtypes = build._SIGNATURES[name]
        p = pointers[name]
        assert argtypes[:p] == [ctypes.c_void_p] * p and argtypes[-1] is ctypes.c_void_p
        assert ctypes.c_void_p not in argtypes[p:-1]
        floats = 0 if name in probes else 1 if name == "hybrid_hub_launch" else 2
        assert argtypes.count(ctypes.c_float) == floats


def test_each_source_is_compiled_by_its_own_nvcc(monkeypatch, tmp_path):
    calls = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)
            if "-o" in cmd:
                Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return "", ""

    monkeypatch.setattr(build.shutil, "which", lambda name: "/nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    # the library "loaded": one plain object per C entry point
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        **{name: types.SimpleNamespace() for name in build._SIGNATURES}))
    build.build_kernels.cache_clear()
    try:
        lib = build.build_kernels()
    finally:
        build.build_kernels.cache_clear()
    assert lib.spmm_edge_launch.argtypes == build._SIGNATURES["spmm_edge_launch"]
    compiles, link = calls[:-1], calls[-1]
    assert sorted(Path(c[-1]).name for c in compiles) == sorted(
        p.name for p in build._sources())
    assert all("-c" in c and "-shared" not in c for c in compiles)
    assert "-shared" in link and sum(a.endswith(".o") for a in link) == len(compiles)
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        f"libsextans_kernels_{build._source_hash()}.so"]


def test_check_launch_raises_on_cuda_error():
    class FakeLib:
        @staticmethod
        def sx_error_string(err):
            return b"too many resources requested for launch"

    build.check_launch(FakeLib, "spmm_slab", 0)
    with pytest.raises(RuntimeError, match="too many resources"):
        build.check_launch(FakeLib, "spmm_slab", 7)


def test_cuda_device_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("checks a host without a CUDA device")
    coo = tx.COOMatrix.random(64, 64, 200, seed=1)
    with pytest.raises((RuntimeError, AssertionError)):
        tx.SpmmPlan(tx.pack(coo), 8, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        tx.HybridSpmmPlan(tx.split_structure(coo, n=8), 8, backend="pallas", device="cuda")


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("fmt", ["ell"])
def test_precise_raises_not_implemented(precise, fmt):
    """Precise mode of the ELL engine was the last one refused (the name
    this test kept from then, so its cases stay one history); it now runs
    through ``plan`` and ``spmm`` (``ell_pallas``: 1.0 ulp of max|C|, its
    virtual rows round to f32 before the f64 fold) and ``plan(..., "ell")``
    (f64 throughout: 0.5001 ulp) on the CPU, and a level outside 0-2 still
    raises."""
    coo = tx.COOMatrix.random(200, 200, 900, seed=precise)
    cfg = tx.SpmmConfig(tile_m=128, window_k=128, precise=precise)
    packer = {"ell": tx.pack_ell}[fmt]
    packed = packer(coo, cfg)
    rng = np.random.default_rng(precise)
    b = rng.standard_normal((200, 16)).astype(np.float32)
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, 1.0, 0.0, None)
    ulp = np.spacing(np.float32(np.abs(exact).max()))
    auto = tx.plan(packed, 16, device="cpu")
    assert auto.backend == "ell_pallas"
    runs = {1.0: (auto(b), tx.spmm(packed, b, device="cpu")),
            0.5001: (tx.plan(packed, 16, "ell", device="cpu")(b),)}
    for bar, gots in runs.items():
        for got in gots:
            assert np.abs(got.numpy().astype(np.float64) - exact).max() <= bar * ulp
    with pytest.raises(ValueError, match="precise"):
        tx.SpmmConfig(precise=3)


def test_smoke_bound_and_no_card_refusal(capsys):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    # cant_like at N = 512: 30 MB of A, 128 MB of B, 2 x 128 MB of C
    ms, by = smoke.bound(3781404, 62451, 62451, 512)
    assert by == "bytes"
    assert ms == pytest.approx((8 * 3781404 + 12 * 62451 * 512) / 3.35e12 * 1e3)
    ms, by = smoke.bound(10**9, 8, 8, 4096)  # dense work on tiny B and C
    assert by == "operations" and ms == pytest.approx(2 * 10**9 * 4096 / 67e12 * 1e3)
    if torch.cuda.is_available():
        pytest.skip("checks a host without a CUDA device")
    assert smoke.main() == 2
    captured = capsys.readouterr()
    assert "is_available() is False" in captured.err and captured.out == ""
