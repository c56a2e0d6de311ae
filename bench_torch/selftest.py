#!/usr/bin/env python3
"""The benchmark's CPU self-test: ``test_bench.py`` under pytest.

    python3 bench_torch/selftest.py

Not part of the repository's tier-1 tests; run it after changing anything
under ``bench_torch/``.
"""

import sys
from pathlib import Path

import pytest

if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    sys.exit(pytest.main([str(here / "test_bench.py"), "-q", "-p", "no:cacheprovider",
                          "--rootdir", str(here.parent), *sys.argv[1:]]))
