"""The port's gather probes (``sextans_tpu_torch/probes/``) against the TPU
probes P1 and P2, on the CPU.

The TPU probes (``benchmarks/scratch/dma_gather_probe.py``,
``benchmarks/scratch/ell_issue_probe.py``) are loaded by file path and run
in Pallas's TPU interpret mode; the same numpy inputs, drawn by the port's
``probe_inputs``, go through the port's wrappers on CPU tensors, that is
through the plain versions that the CUDA kernels equal to the bit on the
card (``tests/test_torch_gpu.py``).

Tolerance: 4 * spacing(f32(max|out|)) against the interpret run and against
the f64 sum: R = 4 terms, each product and sum rounded once in the port,
while XLA:CPU may contract a product and its sum into one FMA.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sextans_tpu_torch.ops.launch import SMEM_LIMIT, SharedMemoryError
from sextans_tpu_torch.probes import dma_gather, ell_issue, gather_bound

REPO = Path(__file__).resolve().parent.parent
K, M, R, BLOCK = 1024, 128, 4, 32


def _load_tpu_probe(name):
    """The TPU probe ``benchmarks/scratch/<name>.py``, loaded by file path.
    Each probe puts a fixed directory first on ``sys.path`` when it is
    imported; ``sys.path`` is put back as it was, so that this process goes
    on finding every module in its own checkout."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_{name}", REPO / "benchmarks" / "scratch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    saved = sys.path[:]
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


_tpu_probe = functools.cache(_load_tpu_probe)


@pytest.mark.parametrize("name,entry", [("dma_gather_probe", "gather_spmm"),
                                        ("ell_issue_probe", "run_variant")])
def test_loading_a_tpu_probe_leaves_sys_path_as_it_was(name, entry):
    before = sys.path[:]
    module = _load_tpu_probe(name)
    assert sys.path == before
    assert callable(getattr(module, entry))


def _interpret():
    # Copies run when they are started ("eager"). Under the interpreter's
    # default, "on_wait", a copy runs when a wait reaches it; P2's variants C
    # and D wait once for several copies on one semaphore, and then return
    # NaN: a flaw of the interpreter, not of the kernels.
    return pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(dma_execution_mode="eager"))


def _ulp(x):
    return float(np.spacing(np.float32(np.abs(x[np.isfinite(x)]).max())))


def _f64(vals, cols, b):
    """The exact sum in f64, value-0 slots adding 0 whatever B holds."""
    rows = np.where((vals != 0)[..., None], b[np.where(vals != 0, cols, 0)].astype(np.float64), 0)
    return np.einsum("mr,mrn->mn", vals.astype(np.float64), rows)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- P1: every slot multiplied ----

@functools.cache
def _p1(n):
    b, cols, vals = dma_gather.probe_inputs(0, k=K, n=n, r=R, m=M)
    with _interpret():
        got = _tpu_probe("dma_gather_probe").gather_spmm(
            jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(b), block=BLOCK, r=R, n=n)
        tpu = np.asarray(got)
    return b, cols, vals, tpu


@pytest.mark.parametrize("staging", dma_gather.STAGINGS)
@pytest.mark.parametrize("n", [16, 128])
def test_p1_matches_the_pallas_probe(n, staging):
    b, cols, vals, tpu = _p1(n)
    before = dma_gather.gather_spmm.launches
    got = dma_gather.gather_spmm(*_t(cols, vals, b), staging=staging).numpy()
    assert dma_gather.gather_spmm.launches == before  # the plain version: no launch
    assert got.shape == (M, n) and np.isfinite(got).all()
    assert np.abs(got - tpu).max() <= 4 * _ulp(tpu)
    assert np.abs(got - _f64(vals, cols, b)).max() <= 4 * _ulp(got)
    want = dma_gather.gather_spmm_ref(*_t(cols, vals, b)).numpy()
    assert np.array_equal(got, want)


def test_p1_probe_inputs_pass_the_probes_own_bar():
    """At the TPU probe's own sizes and seed, under its bar of 1e-4 against
    einsum (dma_gather_probe.py:142-145)."""
    b, cols, vals = dma_gather.probe_inputs(0)
    assert (b.shape, cols.shape, vals.shape) == ((4096, 256), (512, 4), (512, 4))
    assert cols.dtype == np.int32 and 0 <= cols.min() and cols.max() < 4096
    got = dma_gather.gather_spmm(*_t(cols, vals, b)).numpy()
    assert np.abs(got - np.einsum("mr,mrn->mn", vals, b[cols])).max() < 1e-4


# ---- P2: value-0 slots add exactly 0 ----

def _p2_inputs(n_pad):
    """The probe's draws with 30 % value-0 slots, B[0] = NaN, one nonzero
    slot planted on row 0 (row 5) and pads whose columns point at row 0."""
    b, cols, vals = ell_issue.probe_inputs(0, k=K, n=n_pad, r=R, m=M, zero_share=0.3)
    b[0] = np.nan
    vals[5, 1], cols[5, 1] = 1.5, 0
    cols[(vals == 0) & (np.arange(M)[:, None] % 3 == 0)] = 0
    return b, cols, vals


@functools.cache
def _p2(variant, n_pad):
    b, cols, vals = _p2_inputs(n_pad)
    with _interpret():
        got = _tpu_probe("ell_issue_probe").run_variant(
            jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(b), variant, BLOCK, n_pad)
        tpu = np.asarray(got)
    return b, cols, vals, tpu


@pytest.mark.parametrize("port_variant", ell_issue.VARIANTS)
@pytest.mark.parametrize("tpu_variant,n_pad", [("A", 128), ("B", 128), ("C", 128), ("D", 128),
                                               ("A", 512), ("D", 512)])
def test_p2_matches_the_pallas_probe(tpu_variant, n_pad, port_variant):
    b, cols, vals, tpu = _p2(tpu_variant, n_pad)
    got = ell_issue.ell_issue(*_t(vals, cols, b), variant=port_variant).numpy()
    # NaN only in the rows whose nonzero slots meet B[0], in both packages
    hit = ((cols == 0) & (vals != 0)).any(axis=1)
    assert hit[5] and ((cols == 0) & (vals == 0)).any()
    assert np.array_equal(~np.isfinite(got).all(axis=1), hit)
    assert np.array_equal(~np.isfinite(tpu).all(axis=1), hit)
    assert np.abs(got[~hit] - tpu[~hit]).max() <= 4 * _ulp(tpu)
    assert np.abs(got[~hit] - _f64(vals, cols, b)[~hit]).max() <= 4 * _ulp(got)


def test_p2_probe_inputs_follow_the_probe():
    """The probe's sizes and draws, in its order: P1's b, cols, vals at the
    same sizes, then the value-0 mask."""
    b, cols, vals = ell_issue.probe_inputs(0)
    assert (b.shape, cols.shape, vals.shape) == ((4096, 512), (2048, 4), (2048, 4))
    b1, cols1, vals1 = dma_gather.probe_inputs(0, n=512, m=2048)
    assert np.array_equal(b, b1) and np.array_equal(cols, cols1)
    assert np.array_equal(vals[vals != 0], vals1[vals != 0])
    assert 0.25 < (vals == 0).mean() < 0.35
    got = ell_issue.ell_issue(*_t(vals, cols, b)).numpy()
    want = np.einsum("mr,mrn->mn", vals, b[cols] * (vals != 0)[..., None])
    assert np.abs(got - want).max() < 1e-4


def test_p2_pad_columns_may_be_anything():
    b, cols, vals = ell_issue.probe_inputs(3, k=64, n=12, r=3, m=40)
    want = ell_issue.ell_issue(*_t(vals, cols, b)).numpy()
    wild = cols.copy()
    wild[vals == 0] = np.where(np.arange((vals == 0).sum()) % 2, -7, 10**6)
    got = ell_issue.ell_issue(*_t(vals, wild, b)).numpy()
    assert np.array_equal(got, want)


# ---- refusals ----

def _small(seed=1, k=20, n=8, r=3, m=10):
    b, cols, vals = dma_gather.probe_inputs(seed, k=k, n=n, r=r, m=m)
    return _t(cols, vals, b)


@pytest.mark.parametrize("call", [
    lambda c, v, b: dma_gather.gather_spmm(c, v, b),
    lambda c, v, b: ell_issue.ell_issue(v, c, b),
])
@pytest.mark.parametrize("col", [-1, 20, 2**31 - 1])
def test_out_of_range_columns_raise(call, col):
    cols, vals, b = _small()
    cols[4, 2] = col
    vals[4, 2] = 0.5
    with pytest.raises(ValueError, match=r"outside \[0, k=20\)"):
        call(cols, vals, b)


@pytest.mark.parametrize("change,match", [
    (lambda c, v, b: (c.long(), v, b), "cols must be torch.int32"),
    (lambda c, v, b: (c, v.double(), b), "vals must be torch.float32"),
    (lambda c, v, b: (c, v, b.double()), "b must be torch.float32"),
    (lambda c, v, b: (c, v[:, :2].contiguous(), b), "vals must have shape"),
    (lambda c, v, b: (c, v, b[:, ::2]), "b must be contiguous"),
    (lambda c, v, b: (c, v, b[0]), r"\(K, N\)"),
    (lambda c, v, b: (c[:0], v[:0], b), "M, R, K and N >= 1"),
    (lambda c, v, b: (c, v, b[:, :0]), "M, R, K and N >= 1"),
])
@pytest.mark.parametrize("probe", ["dma_gather", "ell_issue"])
def test_bad_operands_raise(probe, change, match):
    cols, vals, b = change(*_small())
    with pytest.raises(ValueError, match=match):
        if probe == "dma_gather":
            dma_gather.gather_spmm(cols, vals, b)
        else:
            ell_issue.ell_issue(vals, cols, b)


def test_bad_options_raise():
    cols, vals, b = _small(n=6)
    with pytest.raises(ValueError, match="staging must be"):
        dma_gather.gather_spmm(cols, vals, b, staging="dma")
    with pytest.raises(ValueError, match="block must be"):
        dma_gather.gather_spmm(cols, vals, b, staging="async", block=0)
    with pytest.raises(ValueError, match="N=6 must be a multiple of 4"):
        dma_gather.gather_spmm(cols, vals, b, staging="async")
    with pytest.raises(ValueError, match="variant must be"):
        ell_issue.ell_issue(vals, cols, b, variant="A")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        dma_gather.gather_spmm(cols.to("meta"), vals.to("meta"), b.to("meta"), checked=False)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ell_issue.ell_issue(vals.to("meta"), cols.to("meta"), b.to("meta"), checked=False)


def test_async_group_rows_fit_shared_memory():
    assert dma_gather.async_group_rows(4, 512, 256) == 4  # 8 KB a row, 32 KB a stage
    assert dma_gather.async_group_rows(8, 512, 256) == 2
    assert dma_gather.async_group_rows(2, 16, 256) == 256  # capped at the block
    assert dma_gather.async_group_rows(2, 16, 1024) == 256
    assert dma_gather.async_group_rows(8, 3600, 256) == 1  # 115,200 B a row, two fit
    with pytest.raises(SharedMemoryError, match="shared memory"):
        dma_gather.async_group_rows(8, 4096, 256)
    assert 2 * 4 * 8 * 4096 > SMEM_LIMIT >= 2 * 4 * 8 * 3600
    b, cols, vals = dma_gather.probe_inputs(0, k=16, n=4096, r=8, m=4)
    with pytest.raises(SharedMemoryError):
        dma_gather.gather_spmm(*_t(cols, vals, b), staging="async")
    # the direct mode has no shared memory to fit
    assert dma_gather.gather_spmm(*_t(cols, vals, b)).shape == (4, 4096)


def test_gather_bound_counts_live_slots_and_distinct_rows():
    cols = torch.tensor([[0, 1], [1, 2], [2, 2]], dtype=torch.int32)
    n = 1000
    ms, by = gather_bound(cols, n)
    assert by == "bytes"
    assert ms == pytest.approx((8 * 6 + 4 * n * 3 + 4 * 3 * n) / 3.35e12 * 1e3)
    live = torch.tensor([[True, False], [False, True], [True, True]])
    ms, _ = gather_bound(cols, n, live=live)
    assert ms == pytest.approx((8 * 6 + 4 * n * 2 + 4 * 3 * n) / 3.35e12 * 1e3)
    ms, by = gather_bound(torch.zeros((1, 10**6), dtype=torch.int32), 10**5)
    assert by == "operations" and ms == pytest.approx(2 * 10**11 / 67e12 * 1e3)


@pytest.mark.parametrize("module", [dma_gather, ell_issue])
def test_sweep_refuses_without_a_card(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks a host without a CUDA device")
    assert module.main() == 2
    captured = capsys.readouterr()
    assert "is_available() is False" in captured.err and captured.out == ""
