"""K5 ``join_probe``: the row-aligned join probe.

:func:`join_probe` packs each probe row's key (exact, or hashed when
the key has no domain; dead rows and, unless ``null_safe``, NULL keys
take a sentinel that never matches), looks it up in the build's CSR
``starts`` table, or binary-searches the sorted keys when the build
has none, and then, by kind: ``INNER`` writes the match into the row
mask and gathers every build output column through ``perm``; ``LEFT``
keeps the row mask and gathers the same way; ``SEMI`` and ``ANTI``
filter the row mask; ``MARK`` returns the match as a BOOLEAN column.
``null_aware`` gives IN / NOT IN their three-valued result from the
build's flags.  The reference's ``_probe_keys``, ``_lookup_first`` and
``probe_join`` in ``presto_tpu/ops/join.py``.  An unmatched row's
gathered data is 0 and its valid bit False.  CUDA tensors launch
``csrc/join_probe.cu``; CPU tensors run :func:`join_probe_plain`.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels import keys as pk

MAX_COLS = 64  # columns gathered by one launch: csrc/gather.cuh GATHER_MAX_COLS
# join kinds: keep in step with csrc/join_probe.cu
INNER, LEFT, SEMI, ANTI, MARK = range(5)
KINDS = {"inner": INNER, "left": LEFT, "semi": SEMI, "anti": ANTI, "mark": MARK}
KIND_NAMES = {v: k for k, v in KINDS.items()}

launches = 0
#: launches by kind name, and by kind name + "_null_aware" for the
#: null-aware ones
kind_launches: dict = {}

Column = Tuple[torch.Tensor, torch.Tensor]


def join_probe_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                     sorted_keys: torch.Tensor, perm: torch.Tensor,
                     starts: Optional[torch.Tensor], build_cols: Sequence[Column],
                     kind: int = INNER, null_safe: bool = False, null_aware: bool = False,
                     flags: Optional[torch.Tensor] = None):
    """``([(data, valid)...], row mask)`` of the probe; the plain
    version."""
    n = row_mask.shape[0]
    key, ok = pk.pack_plain(keys, n, row_mask.device)
    key_ok = row_mask if null_safe else row_mask & ok
    key = torch.where(key_ok, key, torch.full_like(key, pk.I64_MAX - 1))
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
    if kind in (INNER, LEFT):
        row = torch.where(match, perm[pos].to(torch.int64), torch.zeros_like(pos))
        outs: List[Column] = []
        for data, valid in build_cols:
            keep = match.view((n,) + (1,) * (data.dim() - 1))
            outs.append((torch.where(keep, data[row], torch.zeros_like(data[row])),
                         valid[row] & match))
        return outs, match if kind == INNER else row_mask.clone()
    unknown = torch.zeros_like(match)
    if null_aware:
        unknown = ~match & (flags[1] != 0) & (~key_ok | (flags[0] != 0))
    if kind == SEMI:
        return [], match
    if kind == ANTI:
        return [], row_mask & ~match & ~unknown
    return [(match, ~unknown)], row_mask.clone()


def join_probe(keys: Sequence[pk.Key], row_mask: torch.Tensor, sorted_keys: torch.Tensor,
               perm: torch.Tensor, starts: Optional[torch.Tensor],
               build_cols: Sequence[Column], kind: int = INNER, null_safe: bool = False,
               null_aware: bool = False, flags: Optional[torch.Tensor] = None):
    """Probe ``row_mask``'s rows keyed by ``keys`` against a build
    (``sorted_keys``, ``perm``, optional ``starts``); returns the output
    columns (inner/left: the gathered ``build_cols``; semi/anti: none;
    mark: the mark) and the output row mask.  ``flags`` (the build's
    int32 has-NULL-key and nonempty) is needed when ``null_aware``.
    CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if kind not in KINDS.values():
        raise ValueError(f"join_probe: kind {kind}")
    if kind not in (INNER, LEFT) and build_cols:
        raise ValueError("join_probe: semi, anti and mark gather no build column")
    if null_aware and flags is None:
        raise ValueError("join_probe: null_aware needs the build's flags")
    if not row_mask.is_cuda:
        return join_probe_plain(keys, row_mask, sorted_keys, perm, starts, build_cols, kind,
                                null_safe, null_aware, flags)
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
    tensors = [row_mask, sorted_keys, perm] + pk.check(keys, n, "join_probe")
    if starts is not None:
        tensors.append(starts)
    if null_aware:
        if flags.dtype != torch.int32 or flags.shape != (2,):
            raise ValueError("join_probe: flags must be (2,) int32")
        tensors.append(flags)
    outs: List[Column] = []
    widths = []
    for data, valid in build_cols:
        width = data.element_size() * (data.shape[1] if data.dim() == 2 else 1)
        if data.shape[0] != cap or valid.shape != (cap,) or valid.dtype != torch.bool \
                or width < 1 or data.dim() > 2:
            raise ValueError("join_probe: build columns must be (cap,) or (cap, width)")
        tensors += [data, valid]
        widths.append(width)
        outs.append((torch.empty((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                                 device=data.device),
                     torch.empty(n, dtype=torch.bool, device=data.device)))
    build.require_cuda(tensors, "join_probe")
    dev = row_mask.device
    match = torch.empty(n, dtype=torch.bool, device=dev)
    mark = None
    if kind == MARK:
        mark = (torch.empty(n, dtype=torch.bool, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev))
    fn = build.library().k5_join_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p] + pk.C_ARGTYPES + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    # the kernel gathers at most MAX_COLS columns a launch: a wider
    # build takes one launch per run of columns (each probes again and
    # writes the same match flags)
    names = [KIND_NAMES[kind]] + ([KIND_NAMES[kind] + "_null_aware"] if null_aware else [])
    for c0 in range(0, max(len(build_cols), 1), MAX_COLS):
        cols, dsts = build_cols[c0:c0 + MAX_COLS], outs[c0:c0 + MAX_COLS]
        err = fn(n, row_mask.data_ptr(), *pk.c_args(keys),
                 starts.data_ptr() if starts is not None else None,
                 starts.shape[0] - 1 if starts is not None else 0,
                 sorted_keys.data_ptr(), cap, perm.data_ptr(), len(cols),
                 build.ptrs(d.data_ptr() for d, _ in cols),
                 build.ptrs(v.data_ptr() for _, v in cols),
                 build.ptrs(d.data_ptr() for d, _ in dsts),
                 build.ptrs(v.data_ptr() for _, v in dsts),
                 build.ints(widths[c0:c0 + MAX_COLS]), kind, int(null_safe), int(null_aware),
                 flags.data_ptr() if null_aware else None, match.data_ptr(),
                 mark[0].data_ptr() if mark else None, mark[1].data_ptr() if mark else None,
                 build.stream_of(row_mask))
        build.check(err, "join_probe")
        launches += 1  # one per launch: a build past MAX_COLS columns probes once per run
        for name in names:
            kind_launches[name] = kind_launches.get(name, 0) + 1
    return (outs if mark is None else [mark]), match
