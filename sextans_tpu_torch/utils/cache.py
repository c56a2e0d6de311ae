"""Where the kernel library is built.

The counterpart of ``sextans_tpu.utils.cache``, whose persistent JAX
compilation cache moves with ``SEXTANS_TPU_CACHE_DIR``. Here the cache is
the compiled kernel library of ``runtime/build.py`` (keyed by a hash of the
sources and flags, built at first use from the repository's sources): it
goes to ``<SEXTANS_TPU_CACHE_DIR>/sextans_tpu_torch/`` when the variable is
set, else to the default directory beside the package.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CACHE_ENV", "cache_dir"]

CACHE_ENV = "SEXTANS_TPU_CACHE_DIR"


def cache_dir(default: Path) -> Path:
    """``<$SEXTANS_TPU_CACHE_DIR>/sextans_tpu_torch`` when the variable is
    set and not empty, else ``default``."""
    root = os.environ.get(CACHE_ENV)
    return Path(root) / "sextans_tpu_torch" if root else default
