"""SpmmPlan: a reusable, device-resident execution plan for one packed matrix.

The PyTorch counterpart of ``sextans_tpu.ops.plan.SpmmPlan``: the packed
arrays and the host scan that their kernels walk are uploaded once
(memoized on the packed object per device). On the ``mxu``, ``edge`` and
``ell_pallas`` routes each call hands the kernel the caller's B and C
where they lie (at K and M rows) and takes back an (M, N) output: the
kernels mask the ragged last K-window and M-tile themselves. The
``pallas``, ``xla`` and ``ell`` routes pad B to ``k_padded`` and C to
``m_padded``, run one kernel and slice the result. N is not padded: the
kernels mask a ragged last column chunk. ``repeat`` carries the padded C,
as the JAX package does.

``FORMAT_TABLE`` gives each format's packer, pack type, upload and
backends, which keep the JAX package's names so that flags read the same:
``pallas`` (K3) and ``xla`` (its plain version) over ``pack``, ``mxu`` (K1,
K2 for N <= 32) over ``pack_mxu``, ``edge`` (K4) over ``pack_edge``,
``ell_pallas`` (K5) and ``ell`` (the plain ELL engine) over ``pack_ell``;
``"auto"`` runs the first of the pack's format.

``device`` is explicit. On a CUDA device the plan launches the kernels; on
the CPU the same calls run their plain versions. ``SpmmConfig.precise`` (1
or 2) runs the compensated levels of the block, slab, edge and ELL kernels
and the f64 ``ell`` engine; ``xla`` ignores it.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sextans_tpu_torch.format.pack import PackedSpMatrix, pack
from sextans_tpu_torch.format.pack_edge import PackedSpMatrixEdge, pack_edge
from sextans_tpu_torch.format.pack_ell import PackedSpMatrixELL, pack_ell
from sextans_tpu_torch.format.pack_mxu import PackedSpMatrixMXU, pack_mxu
from sextans_tpu_torch.ops.launch import PackHost, need, put, put_scan
from sextans_tpu_torch.ops.spmm_block import BLOCK_HOST, block_ref_runner, block_runner
from sextans_tpu_torch.ops.spmm_edge import EDGE_HOST, edge_in_place, edge_runner
from sextans_tpu_torch.ops.spmm_ell import ELL_HOST, ell_gather_runner, ell_in_place, ell_runner
from sextans_tpu_torch.ops.spmm_slab import SLAB_HOST, k1_image, slab_in_place, slab_runner
from sextans_tpu_torch.utils.profiling import annotate, count, timed

__all__ = ["SpmmPlan", "BACKENDS", "BACKEND_FORMATS", "PACKS", "FORMATS", "FORMAT_TABLE",
           "FORMAT_OF", "resolve_device", "dense_operand"]


class Engine(NamedTuple):
    """A backend, from its kernel's module: ``runner(packed, n, ranges,
    image)`` gives the plan's ``run``; ``image(config, n, device)``, the
    maker of the kernel's operand tiles or None; ``in_place(packed)``,
    whether a call's B keeps the caller's K rows and its C and output the
    caller's M rows."""

    runner: Callable
    servable: bool = True
    image: Optional[Callable] = None
    in_place: Optional[Callable] = None


class Format(NamedTuple):
    """A pack format: ``"auto"`` runs its first backend, a server its first
    servable one."""

    packer: Callable
    kind: type
    host: PackHost
    backends: Dict[str, Engine]


FORMAT_TABLE = {
    "vpu": Format(pack, PackedSpMatrix, BLOCK_HOST,
                  {"pallas": Engine(block_runner), "xla": Engine(block_ref_runner)}),
    "mxu": Format(pack_mxu, PackedSpMatrixMXU, SLAB_HOST,
                  {"mxu": Engine(slab_runner, image=k1_image, in_place=slab_in_place)}),
    "edge": Format(pack_edge, PackedSpMatrixEdge, EDGE_HOST,
                   {"edge": Engine(edge_runner, in_place=edge_in_place)}),
    "ell": Format(pack_ell, PackedSpMatrixELL, ELL_HOST,
                  {"ell_pallas": Engine(ell_gather_runner, servable=False, in_place=ell_in_place),
                   "ell": Engine(ell_runner)}),
}
FORMAT_OF = {backend: name for name, f in FORMAT_TABLE.items() for backend in f.backends}
BACKENDS = ("auto", *FORMAT_OF)
# backend -> (the packer that makes its format, the pack type it runs on)
BACKEND_FORMATS = {b: FORMAT_TABLE[name][:2] for b, name in FORMAT_OF.items()}
FORMATS = {name: f.packer for name, f in FORMAT_TABLE.items()}
PACKS = tuple(f.kind for f in FORMAT_TABLE.values())
_KINDS = {f.kind: f for f in FORMAT_TABLE.values()}


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def dense_operand(x, shape, name: str, device: torch.device) -> torch.Tensor:
    """``x`` (array or tensor) as an f32 tensor on ``device``; raises unless
    its shape is ``shape``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    return x


@timed("upload_s")
def _upload(packed, host: PackHost, device: torch.device, structure=None):
    """Device copies of the packed arrays and of the host scan their kernels
    walk, as the format's ``host`` gives them, each made once per device
    and kept on the packed object; ``(arrays, ranges)``. A plan over
    ``structure`` (values given at call time) keeps its own."""
    cache = packed.__dict__.setdefault("_dev_cache", {})
    key = str(device) if structure is None else (str(device), "structure")
    checked = "checked" if structure is None else ("checked", "structure")
    if checked not in cache:
        cache[checked] = host.check(packed, structure)
    if cache[checked] is not None:
        packed = cache[checked]
    if key not in cache:
        cache[key] = tuple(put(a, dtype, device) for a, dtype in host.arrays(packed))
    if host.cuda_only and device.type != "cuda":
        return cache[key], None
    scan_key = (key, "scan")
    if scan_key not in cache:
        cache[scan_key] = put_scan(host.scan(packed, structure), device)
    return cache[key], cache[scan_key]


@timed("upload_s")
def _image(packed, device: torch.device, make, vals):
    """The kernel's operand tiles (``make(vals)``, K1's), made once per
    device from the uploaded values and kept beside them."""
    cache = packed.__dict__["_dev_cache"]
    key = (str(device), "slab_image")
    if key not in cache:
        cache[key] = make(vals)
    return cache[key]


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` padded with zero rows to ``rows``, contiguous; ``x`` itself
    where it is both already."""
    if rows > x.shape[0]:
        x = F.pad(x, (0, 0, 0, rows - x.shape[0]))
    return x.contiguous()


class SpmmPlan:
    """SpMM executor for a fixed (packed A, N, backend, device).

    ``structure`` (internal, for ``ops/autodiff.py``): the slots that the
    pack's COO entries fill (:func:`~sextans_tpu_torch.ops.autodiff.structure_mask`).
    Such a plan runs over values given at each call (:meth:`run_values`):
    its host scans walk every block and fold every virtual row that holds
    an entry, whatever the pack's own values, and it keeps no K1 operand
    tiles (``image`` is None; :meth:`run_values` makes them from each call's
    values, so its ``__call__`` cannot run K1 on the tensor cores).
    """

    def __init__(self, packed, n: int, backend: str = "auto", *, device, structure=None):
        fmt = _KINDS.get(type(packed))
        if fmt is None:
            raise TypeError(f"SpmmPlan takes one of {[k.__name__ for k in PACKS]}, not "
                            f"{type(packed).__name__} (see format/convert.py for packs "
                            "made by sextans_tpu)")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        if backend == "auto":
            backend = next(iter(fmt.backends))
        if backend not in fmt.backends:
            raise ValueError(
                f"backend {backend!r} does not match packed format "
                f"{type(packed).__name__}"
            )
        if n < 1:
            raise ValueError(f"N must be positive, got {n}")
        engine = fmt.backends[backend]
        self.backend = backend
        self.packed = packed
        self.m, self.k = packed.shape
        self.n = n
        self.k_padded = packed.k_padded  # the rows B is padded to
        self.device = resolve_device(device)
        if structure is not None and structure.shape != packed.vals.shape:
            raise ValueError(f"structure must be {packed.vals.shape}, got {structure.shape}")
        self.arrays, self.ranges = _upload(packed, fmt.host, self.device, structure)
        # the maker of the kernel's operand tiles, where it reads them (K1 on the tensor cores)
        self._image = engine.image and engine.image(packed.config, n, self.device)
        self.image = (_image(packed, self.device, self._image, self.arrays[0])
                      if self._image and structure is None else None)
        self._run = engine.runner(packed, n, self.ranges, self.image)

        def as_index(p):
            return None if p is None else torch.as_tensor(
                np.asarray(p, dtype=np.int64), device=self.device
            )

        self._col_perm = as_index(packed.col_perm)
        self._row_perm = as_index(packed.row_perm)
        self._inv_row = None
        if packed.row_perm is not None:
            inv = np.empty(self.m, dtype=np.int64)
            inv[packed.row_perm] = np.arange(self.m)
            self._inv_row = as_index(inv)
        # the rows of a call's B, C and output: the caller's where the
        # kernel takes them so (K1, K2, K4, K5), else k_padded and m_padded
        self._in_place = bool(engine.in_place and engine.in_place(packed))
        self._b_rows = self.k if self._in_place else self.k_padded
        self._c_rows = self.m if self._in_place else packed.m_padded
        # the bytes of B, and of B and C, that a call makes (pads and gathers)
        b_bytes = (4 * self._b_rows * n
                   if self._b_rows > self.k or packed.col_perm is not None else 0)
        c_bytes = (4 * self._c_rows * n
                   if self._c_rows > self.m or packed.row_perm is not None else 0)
        self._pad_bytes = (b_bytes, b_bytes + c_bytes)

    def pad_b(self, b, rows: Optional[int] = None) -> torch.Tensor:
        """B as the kernel takes it: column-permuted, padded to ``rows``
        (k_padded by default)."""
        b = dense_operand(b, (self.k, self.n), "B", self.device)
        if self._col_perm is not None:  # A was packed as A[:, col_perm]
            b = b[self._col_perm]
        return _pad_rows(b, self.k_padded if rows is None else rows)

    def pad_c(self, c, rows: Optional[int] = None) -> torch.Tensor:
        """C as the kernel takes it: row-permuted, padded to ``rows``
        (m_padded by default)."""
        c = dense_operand(c, (self.m, self.n), "C", self.device)
        if self._row_perm is not None:  # A was packed as A[row_perm, :]
            c = c[self._row_perm]
        return _pad_rows(c, self.packed.m_padded if rows is None else rows)

    def no_c(self, rows: Optional[int] = None) -> torch.Tensor:
        """The C of a call without one: the kernel never reads it; this
        view gives its shape, ``rows`` (m_padded by default) by N."""
        return torch.zeros(1, device=self.device).expand(
            self.packed.m_padded if rows is None else rows, self.n)

    def operands(self, b, c=None):
        """``(B, C)`` as this plan's kernel takes them in a call: at the
        caller's K and M rows where the kernel masks the ragged edges
        itself, else padded (:meth:`pad_b`, :meth:`pad_c`); without ``c``
        the :meth:`no_c` view of C's shape."""
        return (self.pad_b(b, self._b_rows),
                self.no_c(self._c_rows) if c is None else self.pad_c(c, self._c_rows))

    def run_values(self, pv: torch.Tensor, b_p, c_p, alpha, beta, *,
                   with_c: bool = True) -> torch.Tensor:
        """The plan's kernel over ``pv``, packed values given at this call
        (the pack's values' shape, f32, on the plan's device), in place of
        the uploaded ones: B and C in as :meth:`operands` gives them (or
        padded), an output of C's rows out. Where
        K1 runs on the tensor cores, its operand tiles are made from ``pv``
        for this call (:func:`~sextans_tpu_torch.ops.spmm_slab.slab_image`)."""
        need(pv, "pv", torch.float32, self.arrays[0].shape, self.device)
        image = {}
        if self._image:
            with annotate("sx.plan.slab_image", self.device):
                image["image"] = self._image(pv)
        return self._run(pv, *self.arrays[1:], b_p, c_p, alpha, beta, with_c=with_c, **image)

    def unpad(self, out: torch.Tensor) -> torch.Tensor:
        """The (M, N) result of a kernel output of M or more rows."""
        if out.shape[0] != self.m:
            out = out[: self.m]
        return out if self._inv_row is None else out[self._inv_row]

    def __call__(self, b, alpha=1.0, beta=0.0, c=None) -> torch.Tensor:
        """``alpha * A @ b + beta * c`` (M, N), inside the span
        ``sx.plan.call``. Counts ``plan.calls``, ``plan.pad_bytes`` and, on
        the ``mxu``, ``edge`` and ``ell_pallas`` routes, whose B has K rows
        and C and output M rows, ``plan.in_place`` (``utils/profiling.py``)."""
        with_c = c is not None
        if not with_c:
            if float(beta) != 0.0:
                raise ValueError("beta != 0 requires an input C")
            beta = 0.0
        count("plan.calls")
        count("plan.pad_bytes", self._pad_bytes[with_c])
        if self._in_place:
            count("plan.in_place")
        with annotate("sx.plan.call"):
            b_p, c_p = self.operands(b, c)
            return self.unpad(self._run(*self.arrays, b_p, c_p, alpha, beta, with_c=with_c))

    def repeat(self, b, alpha=1.0, beta=0.0, c=None, times: int = 1) -> torch.Tensor:
        """Run the kernel ``times`` times on the current stream, feeding C
        back each time (the reference's rp_time loop). Padding and the row
        permutation happen once, outside the loop; the carry is the whole
        padded C, virtual ELL rows included, as in the JAX package."""
        b_p = self.pad_b(b)
        if c is None:
            if float(beta) != 0.0:
                raise ValueError("beta != 0 requires an input C")
            c = torch.zeros((self.m, self.n), dtype=torch.float32)
        c_p = self.pad_c(c)
        for _ in range(times):
            c_p = self._run(*self.arrays, b_p, c_p, alpha, beta)
        return self.unpad(c_p)
