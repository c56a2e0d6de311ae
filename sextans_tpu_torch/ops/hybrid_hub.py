"""The hybrid split's head columns and hub rows as one row-sparse pass.

``hybrid_hub`` adds ``alpha`` times the hub parts of a hybrid split (its
head columns' and hub rows' entries, ops/hybrid.py) into the DIA kernel's
output, in place, row by row; the plain ``"pallas"`` step of
:class:`~sextans_tpu_torch.ops.hybrid.HybridSpmmPlan` runs it after K6 or
K7, the precise one at alpha = 1 into zeros, once a part. On a CUDA tensor
it launches the hand-written kernel of ``csrc/hybrid_hub.cu``; on a CPU
tensor it runs the plain PyTorch version, ``hybrid_hub_ref``, which takes
the same roundings in the same order. Any other device raises.

It replaces no TPU kernel: the JAX package multiplies these parts as dense
planes on the TPU's matrix unit, which on the H100 are two f32 GEMMs over
planes ~0.5 % full and two (M, N) adds. The plan keeps that composition on
its ``"xla"`` route.

The lists (:func:`hub_lists`, made once at upload from the split's planes):
one job per output row that holds an entry, the hub rows first; each job's
entries are its head part (original column ids) then its hub-row part, each
in ascending column.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sextans_tpu_torch.ops.df32 import acc_step, compensated_epilogue, two_prod, two_sum
from sextans_tpu_torch.ops.launch import Launch, f32, fma_f32, need, put, stream_of
from sextans_tpu_torch.runtime.build import build_kernels, check_launch
from sextans_tpu_torch.utils.config import cdiv
from sextans_tpu_torch.utils.profiling import count

__all__ = ["HubLists", "hub_lists", "hub_launch", "hybrid_hub", "hybrid_hub_ref",
           "HUB_PARTS"]

# csrc/hybrid_hub.cu: kWarps, the partial sums of a hub row (and the head
# jobs of a CTA), added in a fixed tree; kThreads
HUB_PARTS = 8
HUB_THREADS = 32 * HUB_PARTS


@dataclass(frozen=True)
class HubLists:
    """The hub parts of a split on their device, as :func:`hub_lists`
    makes them: job ``j`` adds into output row ``rows[j]`` the entries
    ``ptr[j]:mid[j]`` (head columns) and then ``mid[j]:ptr[j+1]`` (its hub
    row), ``cols`` (original column ids) and ``vals`` beside them; the first
    ``n_hub`` jobs are the hub rows, the rest hold head entries only. ``m``
    and ``k`` are A's shape. int32 indices, f32 values."""

    rows: torch.Tensor
    ptr: torch.Tensor
    mid: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n_hub: int
    m: int
    k: int

    @property
    def jobs(self) -> int:
        return self.rows.shape[0]

    @property
    def entries(self) -> int:
        return self.cols.shape[0]

    @property
    def arrays(self) -> tuple:
        return self.rows, self.ptr, self.mid, self.cols, self.vals


def _in_row(rows: np.ndarray) -> np.ndarray:
    """Each entry's position within its row, for ``rows`` ascending."""
    return np.arange(rows.size) - np.searchsorted(rows, rows)


def hub_lists(head_cols, head_dense, head_rows, head_rows_dense, device) -> HubLists:
    """The lists of :class:`HubLists` from a split's head columns (``(H,)``
    column ids and their ``(m, H)`` plane) and hub rows (``(R,)`` strictly
    ascending row ids and their ``(R, k)`` plane), on ``device``: the
    planes' nonzeros, a row's head entries sorted by original column."""
    head_cols = np.asarray(head_cols, dtype=np.int64)
    head_rows = np.asarray(head_rows, dtype=np.int64)
    (m, _), (_, k) = np.shape(head_dense), np.shape(head_rows_dense)
    hr, hk = np.nonzero(head_dense)
    hv, hc = head_dense[hr, hk], head_cols[hk]
    order = np.lexsort((hc, hr))
    hr, hc, hv = hr[order], hc[order], hv[order]
    ur, uc = np.nonzero(head_rows_dense)  # a plane row's columns ascend
    uv, ur = head_rows_dense[ur, uc], head_rows[ur]  # head_rows ascend, so ur does
    n_head, n_hubs = np.bincount(hr, minlength=m), np.bincount(ur, minlength=m)
    hub_jobs = np.flatnonzero(n_hubs)
    jobs = np.concatenate([hub_jobs, np.flatnonzero((n_head > 0) & (n_hubs == 0))])
    ptr = np.zeros(jobs.size + 1, dtype=np.int64)
    np.cumsum(n_head[jobs] + n_hubs[jobs], out=ptr[1:])
    mid = ptr[:-1] + n_head[jobs]
    if ptr[-1] >= 2**31 or max(m, k) >= 2**31:
        raise ValueError(f"hub_lists: {ptr[-1]} entries or shape {(m, k)} exceed int32")
    job_of = np.zeros(m, dtype=np.int64)
    job_of[jobs] = np.arange(jobs.size)
    cols = np.empty(ptr[-1], dtype=np.int32)
    vals = np.empty(ptr[-1], dtype=np.float32)
    at = ptr[job_of[hr]] + _in_row(hr)
    cols[at], vals[at] = hc, hv
    at = mid[job_of[ur]] + _in_row(ur)
    cols[at], vals[at] = uc, uv
    return HubLists(put(jobs, np.int32, device), put(ptr, np.int32, device),
                    put(mid, np.int32, device), put(cols, np.int32, device),
                    put(vals, np.float32, device), int(hub_jobs.size), m, k)


def hub_launch(n: int, lists: HubLists, vec: int) -> Launch:
    """The kernel's thread map and grid (``csrc/hybrid_hub.cu``): the hub
    rows' CTAs first, one per (hub row, 32 * ``vec`` columns), each of
    ``HUB_PARTS`` warps over one partial sum; then the head jobs,
    ``HUB_PARTS`` a CTA, a warp each. No dynamic shared memory."""
    ctas = lists.n_hub * cdiv(n, 32 * vec) + cdiv(lists.jobs - lists.n_hub, HUB_PARTS)
    if ctas >= 2**31:
        raise ValueError(f"hybrid_hub: {ctas} CTAs exceed the grid")
    return Launch(32, vec, HUB_THREADS, (ctas, 1), 0)


def _sums(b, cols, vals, start, length, steps, stride, precise):
    """For each segment ``i``: ``s = fma(vals[e], b[cols[e]], s)`` from 0
    over ``e = start[i] + stride * t`` for ``t < length[i]``, in order (the
    segments in any shape; ``steps`` >= every length); ``precise``: the
    compensated pairs ``(s, c)`` of the kernel's ``mul_acc_step`` instead
    (``c`` is None in plain mode)."""
    s = torch.zeros((*start.shape, b.shape[1]), dtype=torch.float32, device=b.device)
    c = torch.zeros_like(s) if precise else None
    for t in range(steps):
        live = torch.nonzero(length > t, as_tuple=True)
        e = start[live] + stride * t
        if precise:
            p, pe = two_prod(vals[e, None], b[cols[e]])
            s[live], c[live] = acc_step(s[live], c[live], p, pe)
        else:
            s[live] = fma_f32(vals[e, None], b[cols[e]], s[live])
    return s, c


def _into(alpha, s, c, o):
    """``o`` plus alpha times the sum: ``fma(alpha, s, o)``, or for a pair
    ``alpha * (s - c) + o`` rounded once (the kernel's ``pair_into``)."""
    if c is None:
        a = torch.full((1, 1), f32(alpha), dtype=torch.float32, device=o.device)
        return fma_f32(a, s, o)
    return compensated_epilogue(alpha, s, c, 1.0, o)


def hybrid_hub_ref(out: torch.Tensor, b: torch.Tensor, alpha: float,
                   lists: HubLists, precise: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, rounding as it does: for each
    job, the head entries summed in order by one fused multiply-add each
    from 0; the hub entries as ``HUB_PARTS`` partial sums, part ``w`` over
    positions ``w, w + HUB_PARTS, ...``, added in the kernel's tree; then
    ``out = fma(alpha, head, out)`` where the row has head entries and
    ``out = fma(alpha, hub, out)`` where it has hub entries. ``precise``
    (1 or 2): the same sums as compensated pairs, the tree adding pairs
    (``pair_add``), each epilogue ``alpha * (s - c) + out`` rounded once.
    Updates ``out`` in place and returns it."""
    if not lists.jobs:
        return out
    precise = bool(precise)
    rows, ptr, mid, cols = (t.long() for t in lists.arrays[:4])
    vals, nh = lists.vals, lists.n_hub
    o = out[rows]
    heads = mid - ptr[:-1]
    has = heads > 0
    s, c = _sums(b, cols, vals, ptr[:-1], heads, int(heads.max()), 1, precise)
    o[has] = _into(alpha, s[has], c[has] if precise else None, o[has])
    if nh:
        q0, q1 = mid[:nh], ptr[1:nh + 1]
        part = torch.arange(HUB_PARTS, device=out.device)
        counts = (q1 - q0)[:, None] - part  # part w's entries: ceil((L - w) / HUB_PARTS)
        counts = torch.div(counts + HUB_PARTS - 1, HUB_PARTS, rounding_mode="floor").clamp(min=0)
        t, tc = _sums(b, cols, vals, q0[:, None] + part, counts, int(counts.max()), HUB_PARTS,
                      precise)
        h = HUB_PARTS // 2
        while h:
            if precise:  # pair_add: (t, tc) += (t', tc')
                t[:, :h], e = two_sum(t[:, :h], t[:, h:2 * h])
                tc[:, :h] = (tc[:, :h] - e) + tc[:, h:2 * h]
            else:
                t[:, :h] = t[:, :h] + t[:, h:2 * h]
            h //= 2
        live = torch.nonzero(q1 > q0, as_tuple=True)[0]
        o[live] = _into(alpha, t[live, 0], tc[live, 0] if precise else None, o[live])
    out[rows] = o
    return out


def _check(out, b, lists):
    device = out.device
    if out.dim() != 2 or b.dim() != 2:
        raise ValueError("out and b must be 2-D")
    n = b.shape[1]
    need(out, "out", torch.float32, (lists.m, n), device)
    need(b, "b", torch.float32, (lists.k, n), device)
    j, e = lists.jobs, lists.entries
    for t, name, dtype, shape in ((lists.rows, "rows", torch.int32, (j,)),
                                  (lists.ptr, "ptr", torch.int32, (j + 1,)),
                                  (lists.mid, "mid", torch.int32, (j,)),
                                  (lists.cols, "cols", torch.int32, (e,)),
                                  (lists.vals, "vals", torch.float32, (e,))):
        need(t, f"lists.{name}", dtype, shape, device)
    if not 1 <= n < 2**31 or not 0 <= lists.n_hub <= j:
        raise ValueError(f"hybrid_hub: N {n} or n_hub {lists.n_hub} of {j} jobs out of range")
    return n


def hybrid_hub(out: torch.Tensor, b: torch.Tensor, alpha: float,
               lists: HubLists, precise: int = 0) -> torch.Tensor:
    """``out += alpha * (A_head + A_hub) @ b`` in place over the rows of
    ``lists`` (:func:`hub_lists`), after the DIA kernel on the same stream;
    returns ``out``. ``out`` (M, N) and ``b`` (K, N) are contiguous f32 on
    the lists' device; ``out`` must not be the caller's C. ``precise`` (1
    or 2) sums each row's parts compensated and adds each rounded once
    (:func:`hybrid_hub_ref`). A launch counts ``launch.hybrid_hub``; empty
    lists launch nothing."""
    if out.device.type == "cpu":
        return hybrid_hub_ref(out, b, alpha, lists, precise)
    if out.device.type != "cuda":
        raise ValueError(f"hybrid_hub runs on cpu or cuda, not {out.device}")
    n = _check(out, b, lists)
    if not lists.jobs:
        return out
    vec = 4 if n % 4 == 0 and b.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    go = hub_launch(n, lists, vec)
    lib = build_kernels()
    with torch.cuda.device(out.device):
        err = lib.hybrid_hub_launch(*(t.data_ptr() for t in lists.arrays), b.data_ptr(),
                                    out.data_ptr(), lists.jobs, lists.n_hub, n, float(alpha),
                                    vec, int(bool(precise)), go.threads, go.grid[0],
                                    stream_of(out.device))
    check_launch(lib, "hybrid_hub", err)
    count("launch.hybrid_hub")
    return out
