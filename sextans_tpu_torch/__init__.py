"""sextans_tpu_torch — the SpMM library C = alpha * A @ B + beta * C in
PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

The port of ``sextans_tpu`` (JAX, Pallas kernels for the TPU), which stays
beside it as the reference. The NumPy host layer (Matrix Market I/O, COO/CSR,
the block and slab packers, the golden oracle and the verify gate) is
carried over so that this package never imports JAX; tests hold its packs
byte-identical to the JAX package's. Four packed formats run: the block
format (``pack``), the slab format (``pack_mxu``), the edge stream
(``pack_edge``) and the ELL gather format (``pack_ell``); and the hybrid
structure split (``split_structure`` -> ``HybridSpmmPlan``): diagonals, dense
hub columns and rows, and a residue in one of those formats. Packs persist
in a ``PackCache`` (``$SEXTANS_PACK_CACHE_DIR``), shared with the JAX
package; ``SpmmServer`` serves any matrix through bucket-padded packs.

Quick start::

    import sextans_tpu_torch as sx

    a = sx.read_mtx("matrix.mtx")            # COO, symmetric-expanded
    packed = sx.pack(a)                      # host pack pass (do once)
    c = sx.spmm(packed, b, alpha=0.85, beta=-2.06, c=c0)   # on cuda

``spmm`` runs on ``cuda`` unless ``b`` is a tensor elsewhere or the caller
passes ``device="cpu"``.

The CUDA kernels are compiled at first use into ``sextans_tpu_torch/build/``
(runtime/build.py); on CPU tensors the same calls run plain PyTorch versions.
"""

from sextans_tpu_torch.format.convert import from_reference
from sextans_tpu_torch.format.coo import COOMatrix
from sextans_tpu_torch.format.csr import CSCMatrix, CSRMatrix
from sextans_tpu_torch.format.pack import (
    PackedSpMatrix,
    PackStats,
    pack,
    reorder_columns,
    reorder_rows,
)
from sextans_tpu_torch.format.pack_edge import PackedSpMatrixEdge, pack_edge
from sextans_tpu_torch.format.pack_ell import PackedSpMatrixELL, pack_ell
from sextans_tpu_torch.format.pack_cache import PackCache
from sextans_tpu_torch.format.pack_mxu import PackedSpMatrixMXU, pack_mxu
from sextans_tpu_torch.io.mtx import MtxHeader, read_mtx, read_mtx_coo, write_mtx
from sextans_tpu_torch.ops.golden import golden_spmm, golden_spmm_exact, spmm_flops
from sextans_tpu_torch.ops.hybrid import HybridSplit, HybridSpmmPlan, split_structure
from sextans_tpu_torch.ops.plan import SpmmPlan
from sextans_tpu_torch.ops.serve import ServePlan, SpmmServer, bucketize_pack
from sextans_tpu_torch.ops.spmm import plan, prepare, spmm
from sextans_tpu_torch.parallel.partition import ShardedSpMatrix, pack_sharded, pack_sharded_k
from sextans_tpu_torch.utils.config import SpmmConfig
from sextans_tpu_torch.utils.verify import VerifyResult, gflops, verify

__version__ = "0.1.0"

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "CSCMatrix",
    "PackedSpMatrix",
    "PackStats",
    "MtxHeader",
    "SpmmConfig",
    "VerifyResult",
    "read_mtx",
    "read_mtx_coo",
    "write_mtx",
    "pack",
    "reorder_columns",
    "reorder_rows",
    "pack_mxu",
    "pack_edge",
    "pack_ell",
    "PackedSpMatrixEdge",
    "PackedSpMatrixELL",
    "PackedSpMatrixMXU",
    "from_reference",
    "HybridSplit",
    "split_structure",
    "HybridSpmmPlan",
    "prepare",
    "plan",
    "SpmmPlan",
    "spmm",
    "PackCache",
    "SpmmServer",
    "ServePlan",
    "bucketize_pack",
    "ShardedSpMatrix",
    "pack_sharded",
    "pack_sharded_k",
    "golden_spmm",
    "golden_spmm_exact",
    "spmm_flops",
    "verify",
    "gflops",
]
