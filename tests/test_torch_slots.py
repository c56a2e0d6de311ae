"""The port's slot maps against the JAX package's, and its scatter.

``sextans_tpu_torch/format/slots.py`` is a copy of
``sextans_tpu/format/slots.py``: its ``slot_map`` must equal the JAX one
byte for byte, and the value op's scatter (``ops/autodiff.py:ValueScatter``,
COO entry order on every device) must reproduce each pack's ``vals`` bit
for bit, as ``np.add.at`` does in ``tests/test_slots.py``.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu.format.coo import COOMatrix as RefCOO
from sextans_tpu.format.slots import slot_map as ref_slot_map
from sextans_tpu.utils.config import SpmmConfig as RefConfig
from sextans_tpu_torch.ops.autodiff import ValueScatter
from sextans_tpu_torch.ops.plan import FORMATS


def _coo(seed=0, m=300, k=260, nnz=2500):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, k, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[vals == 0] = 1.0
    return tx.COOMatrix((m, k), rows, cols, vals), RefCOO((m, k), rows, cols, vals)


# tests/test_slots.py's CASES
CASES = [
    ("vpu", dict(tile_m=64, window_k=64, block_k=8, group_blocks=16)),
    ("vpu", dict(tile_m=64, window_k=64, block_k=8, group_blocks=16, interleave=False)),
    ("vpu", dict(tile_m=32, window_k=128, block_k=4, group_blocks=32)),
    ("mxu", dict(tile_m=128, window_k=256, block_k=8, group_blocks=4)),
    ("mxu", dict(tile_m=256, window_k=128, block_k=16, group_blocks=2)),
    ("edge", dict(tile_m=64, window_k=64, edge_chunk=64, edge_lanes=1)),
    ("edge", dict(tile_m=64, window_k=64, edge_chunk=64, edge_lanes=4)),
    ("ell", dict(tile_m=32, ell_r=4)),
    ("ell", dict(tile_m=32)),  # auto slots-per-row
]


def _scatter(slots, vals, shape):
    return ValueScatter(slots, shape, torch.device("cpu"))(torch.as_tensor(vals)).numpy()


@pytest.mark.parametrize("fmt,kw", CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_slot_map_byte_identical(fmt, kw, seed):
    port, ref = _coo(seed=seed)
    got = tx.slot_map(port, tx.SpmmConfig(**kw), fmt)
    want = ref_slot_map(ref, RefConfig(**kw), fmt)
    assert got.dtype == want.dtype and got.shape == want.shape == (port.nnz,)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("fmt,kw", CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_scatter_reproduces_pack(fmt, kw, seed):
    port, _ = _coo(seed=seed)
    cfg = tx.SpmmConfig(**kw)
    packed = FORMATS[fmt](port, cfg)
    got = _scatter(tx.slot_map(port, cfg, fmt), port.vals, packed.vals.shape)
    assert got.tobytes() == np.ascontiguousarray(packed.vals).tobytes()


@pytest.mark.parametrize("fmt", ["vpu", "mxu", "edge", "ell"])
def test_duplicates_sum_like_pack(fmt):
    """Duplicates sum in COO entry order, to the packs' bits: three adds of
    values whose f32 sum depends on the order."""
    rows = np.array([3, 3, 3, 3, 9], np.int32)
    cols = np.array([5, 5, 7, 5, 2], np.int32)
    vals = np.array([1.0, 2.0**-24, 4.0, -1.0, 0.5], np.float32)
    port = tx.COOMatrix((130, 140), rows, cols, vals)
    cfg = tx.SpmmConfig(tile_m=128, window_k=128, block_k=8, group_blocks=16,
                        edge_chunk=64, ell_r=4)
    packed = FORMATS[fmt](port, cfg)
    slots = tx.slot_map(port, cfg, fmt)
    ref_slots = ref_slot_map(RefCOO(port.shape, rows, cols, vals),
                             RefConfig(tile_m=128, window_k=128, block_k=8, group_blocks=16,
                                       edge_chunk=64, ell_r=4), fmt)
    assert slots.tobytes() == ref_slots.tobytes()
    got = _scatter(slots, vals, packed.vals.shape)
    assert got.tobytes() == np.ascontiguousarray(packed.vals).tobytes()


def test_scatter_adds_ranks_in_entry_order():
    """Each slot's entries go in one at a time, in entry order: (1 + 2^-24) +
    -1 = 0 where another order would give 2^-24, and a -0 into an empty slot
    gives +0, as ``np.add.at`` on zeros does."""
    slots = np.array([4, 4, 4, 1, 0], np.int64)
    vals = np.array([1.0, 2.0**-24, -1.0, -0.0, 3.0], np.float32)
    want = np.zeros(6, np.float32)
    np.add.at(want, slots, vals)
    got = _scatter(slots, vals, (2, 3))
    assert got.reshape(-1).tobytes() == want.tobytes()
    assert got.reshape(-1)[4] == 0.0 and not np.signbit(got.reshape(-1)[1])
    assert _scatter(np.zeros(0, np.int64), np.zeros(0, np.float32), (2, 2)).tobytes() == \
        np.zeros((2, 2), np.float32).tobytes()


def test_reorder_cols_consistent():
    port, ref = _coo(seed=3)
    kw = dict(tile_m=64, window_k=64, block_k=8, group_blocks=16)
    cfg = tx.SpmmConfig(**kw)
    packed = tx.pack(port, cfg, reorder_cols=True)
    slots = tx.slot_map(port, cfg, "vpu", reorder_cols=True)
    assert slots.tobytes() == ref_slot_map(ref, RefConfig(**kw), "vpu",
                                           reorder_cols=True).tobytes()
    got = _scatter(slots, port.vals, packed.vals.shape)
    assert got.tobytes() == np.ascontiguousarray(packed.vals).tobytes()


def test_slot_map_refuses_unknown_format_and_maps_empty():
    port, _ = _coo(seed=1)
    with pytest.raises(ValueError, match="unknown pack format"):
        tx.slot_map(port, tx.SpmmConfig(), "dia")
    empty = tx.COOMatrix((8, 8), np.zeros(0), np.zeros(0), np.zeros(0))
    assert tx.slot_map(empty, tx.SpmmConfig(), "vpu").shape == (0,)
