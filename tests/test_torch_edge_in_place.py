"""The plan's edge route at the operands' real size, on the CPU.

``SpmmPlan.__call__`` on the ``edge`` route hands the kernel (on the CPU
its plain version, ``spmm_edge_padded_ref``) the caller's (K, N) B and
(M, N) C where they lie and takes back a fresh (M, N) output: no pad of B
to whole K-windows, none of C to whole M-tiles, no slice. Held here to the
padded route (``pad_b``, ``pad_c``, the padded plain version, ``unpad``)
value for value at every precise level, with the counters ``plan.in_place``
and ``plan.pad_bytes``; ``edge_in_place`` holds for every pack of
``pack_edge`` and not for one whose slots read past K; ``repeat`` still
carries the padded rows.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

import numpy as np
import pytest
import torch

import sextans_tpu_torch as tx
from sextans_tpu_torch.format.pack_edge import COL_SHIFT
from sextans_tpu_torch.ops.spmm_edge import edge_in_place, spmm_edge_padded_ref
from sextans_tpu_torch.utils import profiling

ALPHA, BETA = 0.85, -2.06
N = 24


def _coo():
    # 230 x 300: the last M-tile and the last K-window are both ragged
    return tx.COOMatrix.random(230, 300, 2500, seed=3, banded=True, bandwidth=60)


def _pack(coo, precise=0, lanes=1, **kw):
    cfg = tx.SpmmConfig(tile_m=64, window_k=128, edge_chunk=64, edge_lanes=lanes,
                        precise=precise)
    return tx.pack_edge(coo, cfg, **kw)


def _operands(m, k, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((k, N)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((m, N)).astype(np.float32)))


def _padded_route(pl, b, c):
    """The parent's route: B and C padded, the padded kernel, the slice."""
    cfg = pl.packed.config
    c_p = pl.no_c() if c is None else pl.pad_c(c)
    out = spmm_edge_padded_ref(*pl.arrays, pl.pad_b(b), c_p, ALPHA, 0.0 if c is None else BETA,
                               tile_m=cfg.tile_m, window_k=cfg.window_k,
                               edge_chunk=cfg.edge_chunk, masked=cfg.edge_masked,
                               with_c=c is not None, precise=cfg.precise)
    assert out.shape == (pl.packed.m_padded, N)
    return pl.unpad(out)


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("precise", [0, 1, 2])
@pytest.mark.parametrize("with_c", [True, False])
def test_in_place_call_equals_the_padded_route(with_c, precise, lanes):
    coo = _coo()
    packed = _pack(coo, precise, lanes)
    assert packed.k_padded > coo.shape[1] and packed.m_padded > coo.shape[0]
    pl = tx.plan(packed, N, "edge", device="cpu")
    b, c = _operands(*coo.shape)
    b0, c0 = b.clone(), c.clone()
    got = pl(b, ALPHA, BETA, c) if with_c else pl(b, ALPHA)
    assert tuple(got.shape) == (coo.shape[0], N) and got._base is None
    assert torch.equal(got, _padded_route(pl, b, c if with_c else None))
    assert torch.equal(b, b0) and torch.equal(c, c0)  # the caller's operands, read only


def test_in_place_counters_and_no_pad_bytes(monkeypatch):
    coo = _coo()
    pl = tx.plan(_pack(coo), N, "edge", device="cpu")
    b, c = _operands(*coo.shape)
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    for _ in range(3):
        pl(b, ALPHA, BETA, c)
    for _ in range(2):
        pl(b, ALPHA)
    got = tx.counters()
    assert (got["plan.calls"], got["plan.in_place"], got["plan.pad_bytes"]) == (5, 5, 0)
    assert pl.pad_b(b, pl.k) is b and pl.pad_c(c, pl.m) is c


def test_in_place_call_on_a_reordered_pack(monkeypatch):
    """A pack with its rows and columns reordered: B and C are gathered, not
    padded, and the gathers are counted in ``plan.pad_bytes``."""
    coo = _coo()
    m, k = coo.shape
    packed = _pack(coo, reorder_cols=True, reorder_rows_=True)
    assert packed.col_perm is not None and packed.row_perm is not None
    pl = tx.plan(packed, N, "edge", device="cpu")
    b, c = _operands(m, k, seed=2)
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    got = pl(b, ALPHA, BETA, c)
    pl(b, ALPHA)
    assert tx.counters() == {"plan.calls": 2, "plan.in_place": 2,
                             "plan.pad_bytes": 4 * N * (2 * k + m)}
    assert torch.equal(got, _padded_route(pl, b, c))


@pytest.mark.parametrize("kind", ["banded", "one_window", "empty_rows"])
def test_every_pack_of_pack_edge_is_taken_in_place(kind):
    coo = {"banded": _coo(),
           "one_window": tx.COOMatrix.random(100, 90, 700, seed=4),
           "empty_rows": tx.COOMatrix((300, 260), np.array([0, 299], np.int32),
                                      np.array([0, 259], np.int32),
                                      np.array([1.0, 2.0], np.float32))}[kind]
    packed = _pack(coo, lanes=4)
    assert edge_in_place(packed)
    b, c = _operands(*coo.shape, seed=5)
    pl = tx.plan(packed, N, "edge", device="cpu")
    assert pl._in_place and torch.equal(pl(b, ALPHA, BETA, c), _padded_route(pl, b, c))


def test_a_pack_that_reads_past_k_keeps_the_padded_route(monkeypatch):
    """A slot whose B row lies past K (one a packer would not make): the
    plan pads B to whole K-windows as before."""
    coo = _coo()
    packed = _pack(coo)
    packed.meta, packed.chunk_kwin = packed.meta.copy(), packed.chunk_kwin.copy()
    packed.chunk_kwin[0] = packed.n_kwins - 1  # its first slot reads B row k_padded - 1
    packed.meta.reshape(-1)[0] |= np.int32((packed.config.window_k - 1) << COL_SHIFT)
    assert packed.k_padded - 1 >= coo.shape[1]
    assert not edge_in_place(packed)
    monkeypatch.setattr(profiling, "_COUNTERS", {})
    tx.plan(packed, N, "edge", device="cpu")(*_operands(*coo.shape)[:1], ALPHA)
    assert "plan.in_place" not in tx.counters() and tx.counters()["plan.pad_bytes"] > 0


def test_repeat_carries_the_padded_rows():
    coo = _coo()
    pl = tx.plan(_pack(coo, precise=2), N, "edge", device="cpu")
    b, c = _operands(*coo.shape, seed=6)
    once = pl(b, ALPHA, BETA, c)
    assert torch.equal(pl.repeat(b, ALPHA, BETA, c, times=2), pl(b, ALPHA, BETA, once))
