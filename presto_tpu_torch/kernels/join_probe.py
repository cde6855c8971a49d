"""K5 ``join_probe``: the row-aligned inner-join probe.

:func:`join_probe` packs each probe row's key exactly (dead rows and
NULL keys take a sentinel that never matches), looks it up in the
build's CSR ``starts`` table, or binary-searches the sorted keys when
the build has none, writes the match into the row mask, and gathers
every build output column through ``perm``; the reference's
``_probe_keys``, ``_lookup_first`` and ``probe_join`` (inner) in
``presto_tpu/ops/join.py``.  An unmatched row's gathered data is 0 and
its valid bit False.  CUDA tensors launch ``csrc/join_probe.cu``; CPU
tensors run :func:`join_probe_plain`.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels import keys as pk

MAX_COLS = 32

launches = 0

Column = Tuple[torch.Tensor, torch.Tensor]


def join_probe_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                     sorted_keys: torch.Tensor, perm: torch.Tensor,
                     starts: Optional[torch.Tensor], build_cols: Sequence[Column]):
    """``([(data, valid)...], match)`` of the probe; the plain version."""
    n = row_mask.shape[0]
    key, ok = pk.pack_plain(keys, n, row_mask.device)
    key = torch.where(row_mask & ok, key, torch.full_like(key, pk.I64_MAX - 1))
    cap = sorted_keys.shape[0]
    if starts is not None:
        d = starts.shape[0] - 1
        kk = torch.clamp(key, 0, d - 1)
        lo = starts[kk].to(torch.int64)
        hi = starts[kk + 1].to(torch.int64)
        found = (hi > lo) & (key >= 0) & (key < d)
        pos = torch.clamp(lo, 0, cap - 1)
    else:
        pos = torch.clamp(torch.searchsorted(sorted_keys, key), 0, cap - 1)
        found = sorted_keys[pos] == key
    match = found & row_mask
    row = torch.where(match, perm[pos].to(torch.int64), torch.zeros_like(pos))
    outs: List[Column] = []
    for data, valid in build_cols:
        keep = match.view((n,) + (1,) * (data.dim() - 1))
        outs.append((torch.where(keep, data[row], torch.zeros_like(data[row])),
                     valid[row] & match))
    return outs, match


def join_probe(keys: Sequence[pk.Key], row_mask: torch.Tensor, sorted_keys: torch.Tensor,
               perm: torch.Tensor, starts: Optional[torch.Tensor],
               build_cols: Sequence[Column]):
    """Probe ``row_mask``'s rows keyed by ``keys`` against a build
    (``sorted_keys``, ``perm``, optional ``starts``); returns the
    gathered build columns and the inner join's row mask.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if not row_mask.is_cuda:
        return join_probe_plain(keys, row_mask, sorted_keys, perm, starts, build_cols)
    global launches
    n = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1:
        raise ValueError("join_probe: row_mask must be (n,) bool")
    cap = sorted_keys.shape[0]
    if sorted_keys.dtype != torch.int64 or perm.dtype != torch.int32 \
            or perm.shape != (cap,) or cap < 1:
        raise ValueError("join_probe: build keys int64 (cap,), perm int32 (cap,)")
    if starts is not None and (starts.dtype != torch.int32 or starts.dim() != 1):
        raise ValueError("join_probe: starts must be int32")
    if len(build_cols) > MAX_COLS:
        raise ValueError("join_probe: too many build columns")
    tensors = [row_mask, sorted_keys, perm] + pk.check(keys, n, "join_probe")
    if starts is not None:
        tensors.append(starts)
    outs: List[Column] = []
    widths = []
    for data, valid in build_cols:
        width = data.element_size() * (data.shape[1] if data.dim() == 2 else 1)
        if data.shape[0] != cap or valid.shape != (cap,) or valid.dtype != torch.bool \
                or width not in (1, 4, 8, 16) or data.dim() > 2:
            raise ValueError("join_probe: build columns must be (cap,) or (cap, 2) limbs")
        tensors += [data, valid]
        widths.append(width)
        outs.append((torch.empty((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                                 device=data.device),
                     torch.empty(n, dtype=torch.bool, device=data.device)))
    build.require_cuda(tensors, "join_probe")
    match = torch.empty(n, dtype=torch.bool, device=row_mask.device)
    fn = build.library().k5_join_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p] + pk.C_ARGTYPES + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    err = fn(n, row_mask.data_ptr(), *pk.c_args(keys),
             starts.data_ptr() if starts is not None else None,
             starts.shape[0] - 1 if starts is not None else 0,
             sorted_keys.data_ptr(), cap, perm.data_ptr(), len(build_cols),
             build.ptrs(d.data_ptr() for d, _ in build_cols),
             build.ptrs(v.data_ptr() for _, v in build_cols),
             build.ptrs(d.data_ptr() for d, _ in outs),
             build.ptrs(v.data_ptr() for _, v in outs),
             build.ints(widths), match.data_ptr(), build.stream_of(row_mask))
    build.check(err, "join_probe")
    launches += 1
    return outs, match
