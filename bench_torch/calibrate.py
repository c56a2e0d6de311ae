#!/usr/bin/env python3
"""The readings that the output check's limits are set from, on the card.

    python3 bench_torch/calibrate.py --workload <cell> --seconds <s>
        --seeds <n,n,...> [--control-seeds <n,...>] [--fault-seeds <n,...>]

In one process (the kernel library and the card started once), for each
seed: the cell as the benchmark runs it (``program``), the control (the
reference in TF32 in the program's place) and each fault of ``faults.py``
that the cell's loop can have, each at the cell's own size and load over a
window of ``--seconds``. One JSON line a run, with every number compared
and whether it passed the limits in ``limits/<cell>.json``. The benchmark's
own runs never run the control or a fault.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    args = ap.parse_args(argv)
    os.environ["SEXTANS_TPU_CACHE_DIR"] = str(ROOT / ".bench_cache")
    sys.path.insert(0, str(ROOT))

    import torch

    from bench_torch import faults, harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    calls = harness.load_loop(cell.traffic["loop"]).CALLS
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, lambda ctx: faults.control(ctx.coo(), ctx.vals))
             for s in args.control_seeds]
    runs += [(f, s, (lambda f: lambda ctx: faults.FAULTS[f])(f))
             for f in faults.FAULTS if faults.applies(f, calls) for s in args.fault_seeds]
    for mode, seed, plant in runs:
        t0 = time.perf_counter()
        result, notes = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                                         plant=plant, info=lambda *a: None)
        print(json.dumps({"cell": cell.name, "mode": mode, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "failed": result["failed"], "compared": result["compared"],
                          "setup_s": notes["setup_s"],
                          "run_s": time.perf_counter() - t0}), flush=True)
        del result
        gc.collect()
        torch.cuda.empty_cache()
    print(f"calibrate: {len(runs)} runs in {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
