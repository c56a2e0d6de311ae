"""Precise levels (SpmmConfig.precise = 1, 2) of the port on the CPU.

The df32 functions (``sextans_tpu_torch/ops/df32.py``) are held exact
against f64 and bit-equal to ``sextans_tpu.ops.df32`` on the EFT probe's
inputs. The precise block, slab and edge paths (their plain versions, which
the kernels match on the card) are held to the JAX package's interpret
plans with the same pack, B, C, alpha and beta within 2 ulp of max|C| (the
JAX CPU faithful band: XLA:CPU contracts the EFT sums, ``tests/test_df32.py``)
and, on long accumulations, to ``golden_spmm_exact``: block and edge within
1 ulp of max|C| at level 1 and correctly rounded (0.5001 ulp) at level 2,
slab within 1.5 ulp and no worse than its plain mode.
"""

import torch_cpu  # noqa: F401  one torch thread per xdist worker

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import sextans_tpu as sx
import sextans_tpu_torch as tx
from sextans_tpu.ops import df32 as ref_df32
from sextans_tpu_torch.cli import main as cli_main
from sextans_tpu_torch.ops import df32
from sextans_tpu_torch.ops.launch import SMEM_LIMIT, SharedMemoryError, fma_f32
from sextans_tpu_torch.ops.spmm_block import block_launch

ALPHA, BETA = 0.85, -2.06

FORMATS = {
    # name: (port packer, JAX packer, port backend, JAX backend, config, N)
    "block": (tx.pack, sx.pack, "pallas", "pallas_interpret",
              dict(tile_m=64, window_k=128, block_k=8, group_blocks=16), 24),
    "slab16": (tx.pack_mxu, sx.pack_mxu, "mxu", "mxu_interpret",
               dict(tile_m=128, window_k=128, block_k=16, group_blocks=4), 16),
    "slab64": (tx.pack_mxu, sx.pack_mxu, "mxu", "mxu_interpret",
               dict(tile_m=128, window_k=128, block_k=16, group_blocks=4), 64),
    "edge": (tx.pack_edge, sx.pack_edge, "edge", "edge_interpret",
             dict(tile_m=64, window_k=128, edge_chunk=64, edge_lanes=2), 24),
    "edge_masked": (tx.pack_edge, sx.pack_edge, "edge", "edge_interpret",
                    dict(tile_m=64, window_k=128, edge_chunk=64, edge_lanes=4,
                         edge_masked=True), 13),
}


def _ulp(exact):
    return float(np.spacing(np.float32(np.abs(exact).max())))


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


def _scaled(rng, size):
    return (rng.standard_normal(size)
            * 10.0 ** rng.integers(-6, 6, size).astype(np.float64)).astype(np.float32)


def _rn32(q: Fraction) -> np.float32:
    """``q`` rounded to the nearest f32, ties to even, from exact rationals."""
    x = np.float32(float(q))
    cands = [np.nextafter(x, np.float32(-np.inf)), x, np.nextafter(x, np.float32(np.inf))]
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - q),
                                     int(np.array(y).view(np.int32)) & 1))


# ---- the df32 functions ----

def test_two_sum_and_two_prod_are_exact():
    rng = np.random.default_rng(0)
    a, b = _scaled(rng, 4096), _scaled(rng, 4096)
    s, e = df32.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    p, pe = df32.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(), a64 + b64)
    np.testing.assert_array_equal(p.double().numpy() + pe.double().numpy(), a64 * b64)
    np.testing.assert_array_equal(s.numpy(), a + b)
    np.testing.assert_array_equal(p.numpy(), a * b)


def test_df32_bit_equal_to_jax_on_probe_inputs():
    a, b, _, _ = df32.probe_inputs(0)
    got = df32.eft_probe_pairs(torch.from_numpy(a), torch.from_numpy(b))
    want = (*jax.jit(ref_df32.two_sum)(a, b), *jax.jit(ref_df32.two_prod)(a, b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


def test_acc_step_matches_jax_and_keeps_the_sum():
    rng = np.random.default_rng(7)
    acc, comp, x, xerr = (_scaled(rng, 2048) for _ in range(4))
    got = df32.acc_step(*(torch.from_numpy(t) for t in (acc, comp, x, xerr)))
    want = jax.jit(ref_df32.acc_step)(acc, comp, x, xerr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    t, c = got
    # acc' - comp' == (acc - comp) + x + xerr, up to the two roundings of comp'
    lhs = t.double().numpy() - c.double().numpy()
    rhs = acc.astype(np.float64) - comp + x.astype(np.float64) + xerr
    big = np.maximum.reduce([np.abs(c.numpy()), np.abs(comp), np.abs(xerr)])
    assert np.all(np.abs(lhs - rhs) <= 2 * np.spacing(big).astype(np.float64))


@pytest.mark.parametrize("with_c", [True, False])
def test_compensated_epilogue_rounds_once(with_c):
    rng = np.random.default_rng(3)
    total = rng.standard_normal((8, 128)).astype(np.float32) * 10
    comp = (rng.standard_normal((8, 128)) * 1e-6).astype(np.float32)
    cin = rng.standard_normal((8, 128)).astype(np.float32)
    args = (BETA, torch.from_numpy(cin)) if with_c else ()
    got = df32.compensated_epilogue(ALPHA, torch.from_numpy(total), torch.from_numpy(comp),
                                    *args).double().numpy()
    exact = np.float64(np.float32(ALPHA)) * (total.astype(np.float64) - comp)
    if with_c:
        exact += np.float64(np.float32(BETA)) * cin
    assert (np.abs(got - exact) <= 0.5001 * np.spacing(np.abs(exact).astype(np.float32))).all()


def test_fma_f32_rounds_once():
    # a * b = 2**-24 + 2**-54: the f64 sum with 1 lands on the f32 midpoint
    # 1 + 2**-24 and would round to even (1.0); the exact sum rounds up
    a, b = np.float32(162565 * 2.0**-27), np.float32(6605 * 2.0**-27)
    assert float(a) * float(b) == 2.0**-24 + 2.0**-54
    got = fma_f32(torch.tensor([a]), torch.tensor([b]), torch.tensor([np.float32(1)]))
    assert got.item() == float(np.nextafter(np.float32(1), np.float32(2)))
    rng = np.random.default_rng(9)
    # the last 100 products and sums lie in f32's subnormal range
    scale = np.where(np.arange(600) < 500, 1.0, 1e-22)
    x = (rng.standard_normal(600) * scale).astype(np.float32)
    y = (rng.standard_normal(600) * scale).astype(np.float32)
    z = (rng.standard_normal(600) * np.where(np.arange(600) < 500,
                                             10.0 ** rng.integers(-9, 9, 600),
                                             1e-44)).astype(np.float32)
    assert (np.abs(x[500:] * y[500:] + z[500:]) < np.finfo(np.float32).tiny).mean() > 0.9
    got = fma_f32(*(torch.from_numpy(t) for t in (x, y, z))).numpy()
    want = [_rn32(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r)))
            for p, q, r in zip(x, y, z)]
    np.testing.assert_array_equal(got, np.array(want, dtype=np.float32))


def test_add_rows_compensated_steps_in_visit_order():
    rng = np.random.default_rng(4)
    index = torch.from_numpy(rng.integers(0, 5, 300))
    x = torch.from_numpy(_scaled(rng, (300, 3)))
    acc, comp = torch.zeros(5, 3), torch.zeros(5, 3)
    df32.add_rows_compensated(acc, comp, index, x)
    want_acc, want_comp = torch.zeros(5, 3), torch.zeros(5, 3)
    for i in range(300):
        r = int(index[i])
        want_acc[r], want_comp[r] = df32.acc_step(want_acc[r], want_comp[r], x[i])
    assert torch.equal(acc, want_acc) and torch.equal(comp, want_comp)


def test_eft_probe_plain_version_shows_no_violation():
    a, b, v, bb = df32.probe_inputs(0)
    pairs = [t.numpy() for t in df32.eft_probe_pairs(torch.from_numpy(a), torch.from_numpy(b))]
    chain = df32.eft_probe_chain(torch.from_numpy(v), torch.from_numpy(bb)).numpy()
    report = df32.probe_report(a, b, v, bb, pairs, chain)
    assert report == {"two_sum_violations": 0, "two_prod_violations": 0,
                      "add_mismatches": 0, "mul_mismatches": 0,
                      "chain_excess": report["chain_excess"], "chain_above_floor": 0}
    assert report["chain_excess"] <= 0.0


# ---- the precise paths against the JAX package ----

@pytest.fixture(scope="module")
def matrix():
    return tx.COOMatrix.random(230, 190, 1800, seed=21, banded=True, bandwidth=40)


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_precise_path_matches_jax_interpret(matrix, fmt, precise):
    packer, ref_packer, backend, ref_backend, cfg, n = FORMATS[fmt]
    ref_coo = sx.COOMatrix(matrix.shape, matrix.rows, matrix.cols, matrix.vals)
    b, c = _operands(*matrix.shape, n, seed=precise)
    packed = packer(matrix, tx.SpmmConfig(precise=precise, **cfg))
    got = tx.plan(packed, n, backend, device="cpu")(b, ALPHA, BETA, c).numpy()
    ref_packed = ref_packer(ref_coo, sx.SpmmConfig(precise=precise, **cfg), impl="numpy")
    want = np.asarray(sx.SpmmPlan(ref_packed, n, backend=ref_backend)(b, ALPHA, BETA, c))
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(matrix), b, ALPHA, BETA, c)
    assert got.shape == (matrix.shape[0], n) and np.isfinite(got).all()
    assert tx.verify(exact, got).passed
    assert np.abs(got - want).max() <= 2 * _ulp(exact)
    # no C: the compensated epilogue's alpha * (acc - comp) form
    got = tx.plan(packed, n, backend, device="cpu")(b, 1.5).numpy()
    want = np.asarray(sx.SpmmPlan(ref_packed, n, backend=ref_backend)(b, 1.5))
    assert np.abs(got - want).max() <= 2 * _ulp(want)


def _long_rows(seed):
    """8 rows of 4096 nonzeros in a 64 x 4096 matrix: each output is one
    4096-term dot product (``tests/test_spmm_mxu.py``, ``test_spmm_edge.py``)."""
    rng = np.random.default_rng(seed)
    m, k = 64, 4096
    rows = np.repeat(np.arange(8, dtype=np.int32), k)
    cols = np.tile(np.arange(k, dtype=np.int32), 8)
    coo = tx.COOMatrix((m, k), rows, cols, rng.standard_normal(rows.size).astype(np.float32))
    b = rng.standard_normal((k, 16)).astype(np.float32)
    c = rng.standard_normal((m, 16)).astype(np.float32)
    return coo, b, c


LONG = {
    "block": (tx.pack, "pallas", dict(tile_m=128, window_k=512, block_k=8,
                                      group_blocks=16), 0),
    "slab": (tx.pack_mxu, "mxu", dict(tile_m=128, window_k=512, block_k=8,
                                      group_blocks=16), 0),
    "edge_lanes1": (tx.pack_edge, "edge", dict(tile_m=64, window_k=512, edge_chunk=128,
                                               edge_lanes=1), 3),
    "edge_lanes2": (tx.pack_edge, "edge", dict(tile_m=64, window_k=512, edge_chunk=128,
                                               edge_lanes=2), 3),
}


@pytest.mark.parametrize("precise", [1, 2])
@pytest.mark.parametrize("fmt", list(LONG))
def test_precise_long_accumulation_against_f64(fmt, precise):
    packer, backend, cfg, seed = LONG[fmt]
    coo, b, c = _long_rows(seed)
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    ulp = _ulp(exact)
    errs = {}
    for level in (0, precise):
        packed = packer(coo, tx.SpmmConfig(precise=level, **cfg))
        got = tx.plan(packed, 16, backend, device="cpu")(b, ALPHA, BETA, c).numpy()
        errs[level] = float(np.abs(got.astype(np.float64) - exact).max()) / ulp
    if backend == "mxu":
        assert errs[precise] <= 1.5 and errs[precise] <= errs[0], errs
    else:
        assert errs[precise] <= (1.0 if precise == 1 else 0.5001), errs
        assert errs[precise] < errs[0], errs


@pytest.mark.parametrize("fmt", ["block", "edge_lanes2"])
def test_precise_level_2_rounds_every_element_correctly(fmt):
    """Level 2 of the block and edge paths lands every element on the f32
    nearest to its f64 value (the slab paths run level 2 as level 1)."""
    packer, backend, cfg, _ = LONG[fmt]
    coo, b, c = _long_rows(5)
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    packed = packer(coo, tx.SpmmConfig(precise=2, **cfg))
    got = tx.plan(packed, 16, backend, device="cpu")(b, ALPHA, BETA, c).numpy()
    floor = np.abs(exact.astype(np.float32).astype(np.float64) - exact)
    assert int((np.abs(got.astype(np.float64) - exact) > floor + 1e-12).sum()) == 0


def test_xla_backend_ignores_precise(matrix):
    b, c = _operands(*matrix.shape, 16)
    cfg = FORMATS["block"][4]
    want = tx.plan(tx.pack(matrix, tx.SpmmConfig(**cfg)), 16, "xla", device="cpu")(
        b, ALPHA, BETA, c)
    got = tx.plan(tx.pack(matrix, tx.SpmmConfig(precise=2, **cfg)), 16, "xla",
                  device="cpu")(b, ALPHA, BETA, c)
    assert torch.equal(got, want)


def test_precise_shared_memory_guard():
    # K3 keeps each cell's sum and compensation in registers: no shared
    # memory at any level, so a tile_m of 4096 at precise=1, whose 8 bytes a
    # cell the per-tile accumulator of the earlier design could not hold,
    # plans and runs; the launch depends on N and the stripe count alone
    assert 8 * 4096 * 8 > SMEM_LIMIT >= 4 * 4096 * 8
    assert issubclass(SharedMemoryError, ValueError)
    coo = tx.COOMatrix.random(4200, 300, 4000, seed=5, banded=True, bandwidth=80)
    rng = np.random.default_rng(5)
    b = rng.standard_normal((300, 24)).astype(np.float32)
    c = rng.standard_normal((4200, 24)).astype(np.float32)
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    ulp = np.spacing(np.float32(np.abs(exact).max()))
    for level in (1, 2):
        cfg = tx.SpmmConfig(tile_m=4096, window_k=128, block_k=8, group_blocks=16,
                            precise=level)
        pl = tx.plan(tx.pack(coo, cfg), 24, "pallas", device="cpu")
        assert pl.ranges[0].numel() == 2 * 4096 // 8 + 1  # one list per stripe
        got = pl(b, ALPHA, BETA, c).numpy().astype(np.float64)
        assert np.abs(got - exact).max() <= (1.0 if level == 1 else 0.5001) * ulp
    assert block_launch(24, 1024, precise=1).grid == (1024, 1)  # a CTA a stripe


@pytest.fixture(scope="module")
def mtx_file(tmp_path_factory, matrix):
    path = tmp_path_factory.mktemp("precise") / "a.mtx"
    tx.write_mtx(path, matrix)
    return path


@pytest.mark.parametrize("backend", ["pallas", "mxu", "edge"])
def test_cli_precise_prints_success(mtx_file, backend, capsys):
    rc = cli_main([str(mtx_file), "13", "--backend", backend, "--precise",
                   "--device", "cpu", "--tile-m", "128", "--window-k", "128",
                   "--group-blocks", "16"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "N = 16" in out and "Success!" in out


@pytest.mark.parametrize("flags", [["--backend", "ell"], ["--hybrid", "--backend", "pallas"]])
def test_cli_precise_refuses_paths_not_ported(mtx_file, flags, capsys):
    """The last paths the CLI refused at --precise, the ELL engine and the
    hybrid plan, now run and pass (the name is kept from when they were
    refused, so its cases stay one history)."""
    rc = cli_main([str(mtx_file), "8", "--precise", "--device", "cpu", *flags])
    captured = capsys.readouterr()
    assert rc == 0, captured.out
    assert "Success!" in captured.out
    assert "ROADMAP.md" not in captured.err


@pytest.mark.parametrize("precise", [1, 2])
def test_edge_precise_unmasked_pads_with_nonfinite_b(precise):
    """An unmasked pad adds 0 * B: with B's row 0 infinite (A has no column
    0), exactly the row runs that hold such a pad turn NaN, at every level;
    every other element keeps its precise bar."""
    coo = tx.COOMatrix.random(230, 190, 1800, seed=21, banded=True, bandwidth=40)
    keep = coo.cols != 0
    coo = tx.COOMatrix(coo.shape, coo.rows[keep], coo.cols[keep], coo.vals[keep])
    b, c = _operands(*coo.shape, 16, seed=5)
    b[0] = np.inf
    cfg = dict(tile_m=64, window_k=128, edge_chunk=64, edge_lanes=4)
    got = {level: tx.plan(tx.pack_edge(coo, tx.SpmmConfig(precise=level, **cfg)), 16, "edge",
                          device="cpu")(b, ALPHA, BETA, c).numpy() for level in (0, precise)}
    finite = np.isfinite(got[precise])
    assert not finite.all()
    np.testing.assert_array_equal(finite, np.isfinite(got[0]))
    b[0] = 0.0  # column 0 of A is empty: the same product with B finite
    exact = tx.golden_spmm_exact(tx.CSRMatrix.from_coo(coo), b, ALPHA, BETA, c)
    err = np.abs(got[precise][finite].astype(np.float64) - exact[finite]).max()
    assert err <= (1.0 if precise == 1 else 0.5001) * _ulp(exact)
