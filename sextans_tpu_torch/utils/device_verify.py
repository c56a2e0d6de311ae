"""Full-matrix verification on the device, for outputs too large for the host.

The PyTorch counterpart of ``sextans_tpu.utils.device_verify``. The
reference host checks every element of C against a CPU golden
(sextans-host.cpp:262-290); for a C that does not fit the host's oracle the
f64 oracle runs on the device instead, in bounded blocks, and only two
scalars per block (max|got - exact| and max|exact|) cross to the host.

Per M-block the check uploads the block's edges, recomputes
``alpha * A_block @ B + beta * C_block`` in float64 (a gather of B's rows,
widened after the gather, times the edge values, then ``index_add_`` into
the block's rows, ``edge_chunk`` edges at a time so the f64 transient stays
bounded) and reduces the elementwise error against the kernel's f32 output.

Independence: the oracle shares no code with any kernel or plain version:
a stock gather and ``index_add_`` in another precision, the device twin of
``ops/golden.golden_spmm_exact``. ``index_add_`` on CUDA adds in atomic
order; in f64 that order moves the sum far below an f32 ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from sextans_tpu_torch.format.csr import CSRMatrix

__all__ = ["device_full_check"]


def device_full_check(
    got: torch.Tensor,  # (m, n) f32 on the device: the kernel result to verify
    csr: CSRMatrix,  # the operand in row-sorted form
    b,  # (k, n) f32, array or tensor (pass the kernel's own device copy)
    alpha: float,
    beta: float,
    c,  # (m, n) f32 array or tensor, or None
    block_rows: int = 65536,
    edge_chunk: int = 131072,
) -> dict:
    """Full-matrix check of ``got`` against the f64 oracle, on ``got``'s
    device.

    Returns ``{"max_abs_vs_f64", "c_max_abs", "blocks"}``: the largest
    error of any element, max|exact| for the ulp normalisation, and the
    number of M-blocks. Host traffic: two scalars per block. Device
    footprint: B stays f32; the f64 transients are one (edge_chunk, n)
    gather and one (block_rows, n) sum.
    """
    m, n = csr.shape[0], b.shape[1]
    if not isinstance(got, torch.Tensor) or tuple(got.shape) != (m, n):
        raise ValueError(f"got must be a ({m}, {n}) tensor, got "
                         f"{tuple(getattr(got, 'shape', ()))}")
    dev = got.device
    b32 = torch.as_tensor(b, dtype=torch.float32, device=dev)
    # widen the f32 scalars the kernels actually consume, not the f64
    # literals (see golden_spmm_exact's alpha/beta note)
    a64 = float(np.float32(alpha))
    bt64 = float(np.float32(beta))
    with_c = c is not None and float(beta) != 0.0
    errs, cmaxs = [0.0], [0.0]  # np.max keeps a NaN, Python's max may drop it
    for start in range(0, m, block_rows):
        rows = min(block_rows, m - start)
        lo, hi = int(csr.indptr[start]), int(csr.indptr[start + rows])
        lens = np.diff(csr.indptr[start:start + rows + 1])
        r_local = torch.as_tensor(np.repeat(np.arange(rows, dtype=np.int64), lens), device=dev)
        cols = torch.as_tensor(csr.indices[lo:hi].astype(np.int64), device=dev)
        vals = torch.as_tensor(csr.vals[lo:hi].astype(np.float64), device=dev)
        ab = torch.zeros((rows, n), dtype=torch.float64, device=dev)
        for e0 in range(0, hi - lo, edge_chunk):
            e1 = min(hi - lo, e0 + edge_chunk)
            ab.index_add_(0, r_local[e0:e1],
                          b32[cols[e0:e1]].to(torch.float64) * vals[e0:e1, None])
        exact = a64 * ab
        if with_c:
            exact += bt64 * torch.as_tensor(c[start:start + rows], dtype=torch.float32,
                                            device=dev).to(torch.float64)
        diff = (got[start:start + rows].to(torch.float64) - exact).abs()
        errs.append(diff.max().item())
        cmaxs.append(exact.abs().max().item())
    return {"max_abs_vs_f64": float(np.max(errs)), "c_max_abs": float(np.max(cmaxs)),
            "blocks": len(errs) - 1}
