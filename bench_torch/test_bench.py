"""CPU tests of the benchmark, at a small size on the port's plain versions.

    python -m pytest bench_torch/test_bench.py -q -p no:cacheprovider

The self-test: the copied generators give the program's COO at every
configured argument; every configuration, traffic mix, loop, limit and
metric of ``BENCHMARK.json`` resolves by name; every cell's loop runs (plain
and traced) and comes out correct with no metric, since a CPU run gives no
device number. Then the checks' own tests: the control (the reference in
TF32 in the program's place), every fault of ``faults.py`` that a cell's
loop can have, and a fault that starts only once set-up is over come out
not correct. These are not part of the repository's
tier-1 tests.
"""

from __future__ import annotations

import copy
import importlib
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import faults, harness  # noqa: E402
from bench_torch.pattern import make_pattern  # noqa: E402

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
SEED = 2**31 + 12345  # past 32 signed bits, as the benchmark's seeds may be
# a small FEM matrix and N, and a slab config that cuts it into several
# slabs, K-windows and groups
TINY = {"matrix": {"generator": "fem_like", "args": {"m": 600, "dofs": 3, "neighbors": 5,
                                                     "seed": 2}},
        "n": 40,
        "spmm_config": {"tile_m": 256, "window_k": 512, "block_k": 16, "group_blocks": 8}}


def tiny(name: str) -> harness.Cell:
    """The cell ``name`` with its matrix, N and slab config made small."""
    cell = harness.resolve(BENCH, name)
    cell.config = {**copy.deepcopy(cell.config), **copy.deepcopy(TINY)}
    return cell


def run(cell, plant=None, trace=False, seconds=0.3):
    result, _ = harness.run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                                 plant=plant, info=lambda *a: None)
    return result


def port_twin(module):
    """The program's function that a generator copies (``PORT_TWIN``)."""
    mod_name, attr = module.PORT_TWIN.split(":")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("config", CONFIGS)
def test_generator_copy_gives_the_programs_coo(config):
    conf = next(c for c in BENCH["configs"] if c["name"] == config)
    spec = harness.load_json(harness.ROOT / conf["file"])["matrix"]
    mine = make_pattern(spec)
    module = importlib.import_module(f"bench_torch.generators.{spec['generator']}")
    theirs = port_twin(module)(**spec["args"])
    assert tuple(mine.shape) == tuple(theirs.shape)
    for field in ("rows", "cols", "vals"):
        a, b = getattr(mine, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("config", CONFIGS)
def test_config_states_its_matrix(config):
    conf = next(c for c in BENCH["configs"] if c["name"] == config)
    data = harness.load_json(harness.ROOT / conf["file"])
    pattern = make_pattern(data["matrix"])
    assert (data["rows"], data["cols"], data["nnz"]) == (*pattern.shape, pattern.nnz)
    assert data["name"] == config and data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.resolve(BENCH, name)
    loop = harness.load_loop(cell.traffic["loop"])
    assert callable(loop.setup) and loop.CALLS
    importlib.import_module(f"bench_torch.generators.{cell.config['matrix']['generator']}")
    assert cell.end_to_end and cell.per_layer
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_reader(m["name"]).read)


@pytest.mark.parametrize("path", sorted((harness.BENCH_DIR / "metrics").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_metric_reader_loads(path):
    assert callable(harness.load_reader(path.stem).read)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu_correct_with_no_metric(name, trace):
    cell = tiny(name)
    result = run(cell, trace=trace)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert set(result["compared"]) == set(cell.limits)
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    result = run(tiny(name), plant=lambda ctx: faults.control(ctx.coo(), ctx.vals))
    assert not result["correct"], result["compared"]


FAULT_CASES = [(name, fault) for name in CELLS for fault in faults.FAULTS
               if faults.applies(fault, harness.load_loop(
                   harness.resolve(BENCH, name).traffic["loop"]).CALLS)]


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_fault_is_not_correct(name, fault):
    result = run(tiny(name), plant=lambda ctx: faults.FAULTS[fault])
    assert not result["correct"], result["compared"]


def run_script(root: Path):
    return subprocess.run([sys.executable, "bench_torch/run.py", "--workload", CELLS[0],
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
    proc = run_script(harness.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    for path in harness.load_json(harness.ROOT / "BENCHMARK.json")["paths"]:
        shutil.copytree(harness.ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_script(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def after_set_up(fault: dict, calls: int):
    """A plant of ``fault`` (hooks as in ``faults.FAULTS``) whose every
    call runs as it is for its first ``calls`` calls, broken from then on."""
    def plant(ctx):
        def late(hook):
            def wrap(f):
                broken, n = hook(f), [0]

                def call(*args):
                    n[0] += 1
                    return (f if n[0] <= calls else broken)(*args)
                return call
            return wrap
        return {name: late(hook) for name, hook in fault.items()}
    return plant


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_fault_after_set_up_is_not_correct(name, fault):
    """A fault that starts only once set-up's steps and warm-up are over:
    the window runs it, and the check still sees it."""
    cell = tiny(name)
    calls = int(cell.traffic.get("check_steps", 0)) + int(cell.traffic["warm_units"])
    result = run(cell, plant=after_set_up(faults.FAULTS[fault], calls))
    assert result["attempted"] > 1
    assert not result["correct"], result["compared"]
