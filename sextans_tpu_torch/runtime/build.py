"""Build and load the package's CUDA kernels.

At first use, every ``sextans_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
for Hopper (``sm_90a``), one ``nvcc -c`` per source, all started together,
and the objects are linked into one shared library with a plain C
interface, written to ``sextans_tpu_torch/build/`` under a name keyed by a
hash of the sources and flags, and loaded with ``ctypes``. A later call, or
another process, with the same sources loads the same file without
compiling.

There is no fallback: without ``nvcc`` this raises ``RuntimeError``, and a
failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build_kernels", "find_nvcc", "check_launch", "PACKAGE_DIR"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Every C entry point returns cudaGetLastError() after its launch.
_SIGNATURES = {
    # vals qrow bcol group_kwin tile_ptr tile_groups b c out
    # n_mtiles n tile_m window_k block_k group_blocks tile_n
    # alpha beta with_c precise stream
    "spmm_block_launch": [_P] * 9 + [_I] * 7 + [_F, _F, _I, _I, _P],
    # vals qm bcol group_kwin tile_ptr tile_groups b c out
    # n_mtiles n tile_m window_k block_k group_blocks
    # alpha beta with_c precise stream
    "spmm_slab_launch": [_P] * 9 + [_I] * 6 + [_F, _F, _I, _I, _P],
    "spmm_slab_skinny_launch": [_P] * 9 + [_I] * 6 + [_F, _F, _I, _I, _P],
    # vals meta chunk_kwin tile_ptr tile_chunks b c out comp
    # n_mtiles n tile_m window_k edge_chunk alpha beta with_c masked precise
    # stream
    "spmm_edge_launch": [_P] * 9 + [_I] * 5 + [_F, _F, _I, _I, _I, _P],
    # vals cols b c out m_padded r_slots n alpha beta with_c precise vec stream
    "spmm_ell_launch": [_P] * 5 + [_I] * 3 + [_F, _F, _I, _I, _I, _P],
    # dvals offsets b c out m k n n_diags alpha beta with_c precise [vec] stream
    "spmm_dia_launch": [_P] * 5 + [_I] * 4 + [_F, _F, _I, _I, _I, _P],
    "spmm_dia_skinny_launch": [_P] * 5 + [_I] * 4 + [_F, _F, _I, _I, _P],
    # a b s e p pe count stream
    "df32_probe_pairs": [_P] * 6 + [_I, _P],
    # v b out terms width stream
    "df32_probe_chain": [_P] * 3 + [_I, _I, _P],
    # cols vals b out m r_slots n staging vec block group stream
    "dma_gather_launch": [_P] * 4 + [_I] * 7 + [_P],
    # vals cols b out m r_slots n variant vec stream
    "ell_issue_launch": [_P] * 4 + [_I] * 5 + [_P],
    "sx_error_string": [_I],
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``PATH`` first, then ``$CUDA_HOME/bin``, then the
    toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME]
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked in PATH, $CUDA_HOME/bin and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels of sextans_tpu_torch are "
        "compiled at first use and need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Start every command of ``cmds`` at once and wait for all; raise with
    the compiler's output if any failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def build_kernels() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; cached per process."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libsextans_kernels_{_source_hash()}.so"
    if not lib_path.exists():
        # Build in a private directory, then rename: a concurrent process
        # building the same sources never sees a half-written library.
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
            _run_all([nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(src)]
                     for src, obj in zip(_sources(), objs))
            so = Path(tmp) / "lib.so"
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(so), *map(str, objs)]])
            os.replace(so, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "sx_error_string" else _I
    return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.sx_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} (error {err})")
