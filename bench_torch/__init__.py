"""The benchmark of ``sextans_tpu_torch`` on NVIDIA GPUs.

``python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
needs is found by name: its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<mix>.json`` (which names a loop in
``loops/<loop>.py``), each metric's reader in ``metrics/<metric>.py``, the
limits of its output check in ``limits/<cell>.json`` and its matrix
generator in ``generators/<generator>.py``. Nothing here imports JAX or the
JAX package, and the plain reference (``reference.py``) imports nothing of
the program.
"""
