"""The program's objects that a configuration names: its ``SpmmConfig``,
the COO of A and the packer of its format. Everything the loops take from
the program goes through ``sextans_tpu_torch``'s public entry points."""

from __future__ import annotations

import sextans_tpu_torch as sx

from bench_torch.pattern import Pattern

PACKERS = {"vpu": sx.pack, "mxu": sx.pack_mxu, "edge": sx.pack_edge, "ell": sx.pack_ell}


def spmm_config(config: dict) -> "sx.SpmmConfig":
    return sx.SpmmConfig(**config["spmm_config"])


def coo(pattern: Pattern) -> "sx.COOMatrix":
    return sx.COOMatrix(pattern.shape, pattern.rows, pattern.cols, pattern.vals)


def packed(config: dict, pattern: Pattern):
    """A packed in the configuration's format."""
    return PACKERS[config["format"]](coo(pattern), spmm_config(config))
