#!/usr/bin/env python3
"""Where a product cell's idle goes: the host's time a product and the
card's idle after each of the loop's synchronises.

    python3 tools/restart_idle.py ROOT --workload <cell> --seed <n> [--seconds 10]

imports ``bench_torch`` and the program from the tree at ROOT, sets the cell
up as ``bench_torch/run.py`` does (untraced) and runs its loop as the
harness's ``Caller`` does: one caller, each product started when the last
call returns, a synchronise once ``sync_ms`` of host time has passed since
the last. Besides, it records a CUDA event after every product and reads
the host clock around every call. Prints one JSON line:

* ``spmm_ms``: the window over the products, as ``run.py`` reads it;
* ``device_ms``: a product's device time, the median gap between the
  events of two products in a row within a cycle (the card is behind the
  host there, so the gap is the product's own);
* ``host_ms``: the host's time a call (quartiles), the enqueue alone;
  ``first_host_ms``: the same for a cycle's first call, and ``wake_ms``
  the host's time from a synchronise's return to that call; for a
  ``HybridSpmmPlan`` also its DIA and hub wrappers' (``dia_ms``,
  ``hub_ms``);
* ``per_cycle``: products between two synchronises (quartiles);
* ``restart_ms``: the card's idle at each restart (quartiles): from the
  event of a cycle's last product to that of the next cycle's first, less
  ``device_ms``; ``restart_share``: their sum over the window; of it
  ``return_ms``, up to an event recorded as the synchronise returns;
* ``in_cycle_share``: the rest of the idle, the window less the products'
  device time and the restarts, over the window.

The events and clock reads cost the host ~5 us a product, which this loop
spends and the benchmark's does not.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def quartiles(xs):
    xs = list(xs)
    if len(xs) < 2:
        return xs * 3 if xs else []
    q = statistics.quantiles(xs, n=4)
    return [q[0], statistics.median(xs), q[2]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", type=Path)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    from bench_torch import harness

    cell = harness.resolve(harness.load_json(root / "BENCHMARK.json"), args.workload, root)
    device = torch.device("cuda")
    torch.zeros(1, device=device)
    ctx = harness.make_context(cell, args.seed, device, False)
    loop = harness.load_loop(cell.traffic["loop"]).setup(ctx)
    parts = {}
    plan = getattr(loop, "plan", None)
    if type(plan).__name__ == "HybridSpmmPlan":  # time its wrappers too
        from sextans_tpu_torch.ops import hybrid as hybrid_mod

        def timed(name, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    parts.setdefault(name, []).append(time.perf_counter() - t)
            return call

        if plan._dia is not None:
            plan._dia = timed("dia_ms", plan._dia)
        if hasattr(hybrid_mod, "hybrid_hub"):
            hybrid_mod.hybrid_hub = timed("hub_ms", hybrid_mod.hybrid_hub)

    sync_s = float(cell.traffic["sync_ms"]) / 1e3
    cycles, host, first, wake, returns, events = [], [], [], [], [], []
    loop.sync()
    t0 = last_sync = time.perf_counter()
    i = 0
    while time.perf_counter() < t0 + args.seconds:
        t = time.perf_counter()
        loop.step(i)
        host.append(time.perf_counter() - t)
        if not events and cycles:
            first.append(host[-1])
            wake.append(t - last_sync)
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)
        i += 1
        if time.perf_counter() - last_sync >= sync_s:
            loop.sync()
            last_sync = time.perf_counter()
            returns.append(torch.cuda.Event(enable_timing=True))
            returns[-1].record()
            cycles.append(events)
            events = []
    loop.sync()
    window = time.perf_counter() - t0
    if events:
        cycles.append(events)

    gaps = [a.elapsed_time(b) for c in cycles for a, b in zip(c, c[1:])]
    device_ms = statistics.median(gaps)
    restarts = [a[-1].elapsed_time(b[0]) - device_ms for a, b in zip(cycles, cycles[1:])]
    busy_ms = device_ms * i
    out = {
        "workload": args.workload, "seed": args.seed, "products": i, "syncs": len(cycles),
        "window_s": window, "spmm_ms": window * 1e3 / i, "device_ms": device_ms,
        "host_ms": [x * 1e3 for x in quartiles(host)],
        "first_host_ms": [x * 1e3 for x in quartiles(first)],
        "wake_ms": [x * 1e3 for x in quartiles(wake)],
        **{k: [x * 1e3 for x in quartiles(v)] for k, v in parts.items()},
        "per_cycle": quartiles(len(c) for c in cycles),
        "restart_ms": quartiles(restarts),
        "return_ms": quartiles(a[-1].elapsed_time(r) for a, r in zip(cycles, returns)),
        "restart_share": sum(restarts) / (window * 1e3),
        "in_cycle_share": (window * 1e3 - busy_ms - sum(restarts)) / (window * 1e3),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
