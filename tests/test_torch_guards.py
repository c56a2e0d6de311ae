"""Guards of the PyTorch port: it never imports JAX, its kernels build only
with nvcc and never fall back, and what it does not run yet raises."""

import ctypes
import re
import subprocess
import sys
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
        "import sys, sextans_tpu_torch, sextans_tpu_torch.cli\n"
        "import sextans_tpu_torch.utils.timing, sextans_tpu_torch.utils.matrices\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sextans_tpu', 'triton'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_no_file_of_the_package_imports_jax():
    files = list(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
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
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert {p.name for p in build._sources()} == {"spmm_block.cu", "spmm_slab.cu"}
    assert build._source_hash() == build._source_hash()
    # every pointer and the stream are c_void_p, so none is cut to 32 bits
    for name, argtypes in build._SIGNATURES.items():
        if name.endswith("_launch"):
            assert argtypes[:9] == [ctypes.c_void_p] * 9 and argtypes[-1] is ctypes.c_void_p
            assert argtypes.count(ctypes.c_float) == 2


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
    packed = tx.pack(tx.COOMatrix.random(64, 64, 200, seed=1))
    with pytest.raises((RuntimeError, AssertionError)):
        tx.SpmmPlan(packed, 8, device="cuda")


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("fmt", ["block", "slab"])
def test_precise_raises_not_implemented(precise, fmt):
    coo = tx.COOMatrix.random(200, 200, 900, seed=precise)
    cfg = tx.SpmmConfig(tile_m=128, window_k=128, precise=precise)
    packed = tx.pack_mxu(coo, cfg) if fmt == "slab" else tx.pack(coo, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 6"):
        tx.plan(packed, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tx.spmm(packed, np.ones((200, 16), np.float32), device="cpu")
