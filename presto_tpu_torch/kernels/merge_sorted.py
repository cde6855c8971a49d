"""K22 ``merge_sorted``: two runs sorted by one int64 key each, merged
into one sorted run.

:func:`merge_sorted` computes the reference's ``merge_two_sorted``
(``presto_tpu/ops/merge.py``): a row ``i`` of run a goes to ``i +
lower_bound(key_b, key_a[i])`` and a row ``j`` of run b to ``j +
upper_bound(key_a, key_b[j])``, so equal keys keep a's rows first and
each run's own order; every column (any trailing width), its valid
bits, the row mask and the key are scattered to those positions.  Dead
rows carry INT64_MAX keys at each run's tail.  CUDA tensors launch
``csrc/merge_sorted.cu`` (one launch a run for every column, in runs of
``MAX_COLS``); CPU tensors run the plain version, two
``torch.searchsorted`` calls and one scatter per column.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build

MAX_COLS = 64  # csrc/gather.cuh GATHER_MAX_COLS

#: K22 launch sequences (one per merge of two runs)
launches = 0

Column = Tuple[torch.Tensor, torch.Tensor]
Run = Tuple[Sequence[Column], torch.Tensor, torch.Tensor]  # (columns, row mask, key)


def _check(a: Run, b: Run) -> List[int]:
    widths = []
    for cols, mask, key in (a, b):
        n = mask.shape[0]
        if mask.dtype != torch.bool or mask.dim() != 1:
            raise ValueError("merge_sorted: the row mask must be (n,) bool")
        if key.dtype != torch.int64 or key.shape != (n,):
            raise ValueError("merge_sorted: the key must be (n,) int64")
        if len(cols) != len(a[0]):
            raise ValueError("merge_sorted: the runs must have the same columns")
        w = []
        for data, valid in cols:
            if data.shape[0] != n or valid.shape != (n,) or valid.dtype != torch.bool:
                raise ValueError("merge_sorted: columns must be (n, ...) with (n,) bool valid")
            w.append(data.element_size() * math.prod(data.shape[1:]))
        widths.append(w)
    for (da, _), (db, _) in zip(a[0], b[0]):
        if da.dtype != db.dtype or da.shape[1:] != db.shape[1:]:
            raise ValueError("merge_sorted: a column differs in type or width between the runs")
    return widths[0]


def positions_plain(key_a: torch.Tensor, key_b: torch.Tensor):
    """Each row's merged position: ``(pos_a, pos_b)``."""
    pos_a = torch.arange(key_a.shape[0], device=key_a.device) + \
        torch.searchsorted(key_b, key_a, right=False)
    pos_b = torch.arange(key_b.shape[0], device=key_b.device) + \
        torch.searchsorted(key_a, key_b, right=True)
    return pos_a, pos_b


def merge_sorted_plain(a: Run, b: Run) -> Tuple[List[Column], torch.Tensor, torch.Tensor]:
    """``(columns, row mask, key)`` of the merged run; the plain version."""
    _check(a, b)
    pos_a, pos_b = positions_plain(a[2], b[2])
    n = a[1].shape[0] + b[1].shape[0]

    def merged(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        out = torch.empty((n,) + tuple(xa.shape[1:]), dtype=xa.dtype, device=xa.device)
        out[pos_a] = xa
        out[pos_b] = xb
        return out

    cols = [(merged(da, db), merged(va, vb)) for (da, va), (db, vb) in zip(a[0], b[0])]
    return cols, merged(a[1], b[1]), merged(a[2], b[2])


def merge_sorted(a: Run, b: Run) -> Tuple[List[Column], torch.Tensor, torch.Tensor]:
    """Merge run ``a`` with run ``b``, each ``(columns, row mask, key)``
    sorted by its int64 key: the merged ``(columns, row mask, key)``.
    CPU tensors take the plain version; CUDA tensors launch K22."""
    widths = _check(a, b)
    if not a[1].is_cuda:
        return merge_sorted_plain(a, b)
    global launches
    tensors = [t for run in (a, b) for c in run[0] for t in c] + [a[1], a[2], b[1], b[2]]
    build.require_cuda(tensors, "merge_sorted")
    na, nb = a[1].shape[0], b[1].shape[0]
    n = na + nb
    dev = a[1].device
    out_cols = [(torch.empty((n,) + tuple(d.shape[1:]), dtype=d.dtype, device=dev),
                 torch.empty(n, dtype=torch.bool, device=dev)) for d, _ in a[0]]
    out_mask = torch.empty(n, dtype=torch.bool, device=dev)
    out_key = torch.empty(n, dtype=torch.int64, device=dev)
    fn = build.library().k22_merge_sorted
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8
    for self_, other, upper in ((a, b, 0), (b, a, 1)):
        for c0 in range(0, max(len(out_cols), 1), MAX_COLS):
            src, dst = self_[0][c0:c0 + MAX_COLS], out_cols[c0:c0 + MAX_COLS]
            first = c0 == 0
            err = fn(self_[1].shape[0], self_[2].data_ptr(), self_[1].data_ptr(),
                     other[1].shape[0], other[2].data_ptr(), upper, len(src),
                     build.ptrs(d.data_ptr() for d, _ in src),
                     build.ptrs(v.data_ptr() for _, v in src),
                     build.ptrs(d.data_ptr() for d, _ in dst),
                     build.ptrs(v.data_ptr() for _, v in dst),
                     build.ints(widths[c0:c0 + MAX_COLS]),
                     out_key.data_ptr() if first else None,
                     out_mask.data_ptr() if first else None, build.stream_of(a[1]))
            build.check(err, "merge_sorted")
    launches += 1
    return out_cols, out_mask, out_key
