#!/usr/bin/env python3
"""Run one cell of the benchmark once, on one NVIDIA GPU.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Sets up the cell of ``BENCHMARK.json`` (its
matrix with values from the seed, the program's objects, the inputs, a
warm-up of every shape it uses), runs its loop for ``--seconds``, frees the
program, holds its answers to the plain reference and prints the result as
the last line of standard output: one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics from a traced sub-window),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number compared beside its limit, which also close standard error. An
earlier line gives the card's name, power limit and SM clocks beside the
window. Exits 2 without a result where there is no CUDA card, or fewer than
the cell asks for. The kernel library builds into ``.bench_cache/`` in the
checkout, so only a checkout's first run compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
SMI_FIELDS = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu,power.draw"


def smi() -> str:
    """The card's name, power limit, SM clock and more, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else (
        f"nvidia-smi failed ({out.returncode})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel library, and any Triton or extension build, in
    # fixed directories inside the checkout
    os.environ["SEXTANS_TPU_CACHE_DIR"] = str(CACHE)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from bench_torch import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.resolve(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)

    def info(*parts):
        print("bench:", *parts, file=sys.stderr, flush=True)

    result, notes = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                     T_START, info=info, probe=smi)
    print("bench run " + json.dumps({
        "cell": cell.name, "seed": args.seed, "seconds": args.seconds, "trace": args.trace,
        "smi_fields": SMI_FIELDS, **notes, "torch": torch.__version__,
        "cuda": torch.version.cuda}), flush=True)
    print(json.dumps(result), flush=True)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
