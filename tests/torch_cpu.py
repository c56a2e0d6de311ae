"""One torch thread per pytest-xdist worker, for the port's tests.

Every ``tests/test_torch_*.py`` imports this module first. Under
pytest-xdist (``PYTEST_XDIST_WORKER`` is set) the workers share the host's
cores, and torch gives each worker one intra-op thread per core: six workers
on eight cores then run 48 threads, and a test that takes seconds alone
takes minutes. One thread per worker leaves the workers the cores. A file
run by hand, without xdist, keeps all its threads.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
