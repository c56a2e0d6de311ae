"""Typed configuration for the SpMM pipeline.

The same dataclass, fields and validation as ``sextans_tpu.utils.config``, so
that a config (and a pack built with it) means the same thing in both
packages. The TPU's scoped-VMEM envelope is not carried: each CUDA wrapper
checks its own shared-memory request instead and raises ``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

__all__ = ["SpmmConfig", "cdiv", "round_up"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclass(frozen=True)
class SpmmConfig:
    """Tiling configuration for pack + kernel.

    * ``tile_m``   — rows per M-tile; one CUDA block owns a tile's
      accumulator (or one 128-row slab of it).
    * ``window_k`` — columns of A (= rows of B) per K-window; packed column
      offsets are relative to their window.
    * ``block_k``  — width of a packed block: A is packed into dense
      8 x block_k blocks (block format) or block_k x 128 slabs (slab format).
    * ``group_blocks`` — blocks per group; all blocks of a group share one
      (M-tile, K-window) pair.
    * ``tile_n``   — the TPU's N-panel width; the CUDA kernels pick their own
      column chunk and do not read it.
    * ``interleave`` — round-robin blocks across row stripes inside a group
      (block format); changes the summation order, never the result's
      correctness.
    * ``n_acc``, ``chunk_unroll`` — TPU scheduling hints, kept so that configs
      are interchangeable; the CUDA kernels ignore them.
    * ``precise`` — compensated accumulation (0 off, 1 Neumaier + df32
      epilogue, 2 full error-free inner chain). Only 0 runs in this package.
    * ``edge_chunk``, ``edge_lanes``, ``ell_r``, ``edge_masked`` — knobs of
      the edge and ELL formats, which this package does not run yet.
    """

    tile_m: int = 512
    window_k: int = 2048
    block_k: int = 8
    group_blocks: int = 256
    tile_n: Optional[int] = None
    interleave: bool = True
    n_acc: int = 1
    chunk_unroll: int = 2
    precise: int = 0
    edge_chunk: int = 2048
    edge_lanes: int = 1
    ell_r: Optional[int] = None
    edge_masked: bool = False

    def __post_init__(self):
        if self.tile_m % 8 != 0 or self.tile_m <= 0:
            raise ValueError("tile_m must be a positive multiple of 8")
        if self.block_k not in (1, 2, 4, 8, 16, 32, 64, 128):
            raise ValueError("block_k must be a power of two <= 128")
        if self.window_k % self.block_k != 0:
            raise ValueError("window_k must be a multiple of block_k")
        if self.window_k % 8 != 0:
            raise ValueError("window_k must be a multiple of 8")
        if self.group_blocks <= 0:
            raise ValueError("group_blocks must be positive")
        if self.tile_n is not None and self.tile_n % 128 != 0:
            raise ValueError("tile_n must be a multiple of 128 (TPU lane count)")
        if self.n_acc < 1 or self.chunk_unroll < 1:
            raise ValueError("n_acc and chunk_unroll must be >= 1")
        if int(self.precise) not in (0, 1, 2):
            raise ValueError("precise must be 0/False, 1/True, or 2")
        if self.edge_chunk <= 0 or self.edge_chunk % 8 != 0:
            raise ValueError("edge_chunk must be a positive multiple of 8")
        if self.edge_lanes not in (1, 2, 4, 8):
            raise ValueError("edge_lanes must be 1, 2, 4, or 8")
        if self.edge_chunk % self.edge_lanes != 0:
            raise ValueError("edge_chunk must be a multiple of edge_lanes")
        if self.ell_r is not None and self.ell_r < 1:
            raise ValueError("ell_r must be >= 1")

    def validate_vpu(self) -> None:
        """Extra constraint of the block format (format/pack.py): groups hold
        whole 128-lane chunks of 128//block_k blocks each, as in the JAX
        package, so that the two packs stay byte-identical."""
        chunk = max(1, 128 // self.block_k)
        if self.group_blocks % chunk != 0:
            raise ValueError(
                f"group_blocks must be a multiple of {chunk} (=128/block_k) "
                "for the VPU block format"
            )

    @property
    def stripes_per_tile(self) -> int:
        return self.tile_m // 8

    def with_(self, **kw) -> "SpmmConfig":
        return replace(self, **kw)

    def resolve_tile_n(self, n: int) -> int:
        if self.tile_n is not None:
            return self.tile_n
        return min(round_up(n, 128), 512)
