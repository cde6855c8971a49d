"""K19 ``ml_state``: the ML aggregates' sufficient statistics per group.

The reference's partial states of ``learn_regressor`` /
``learn_classifier`` (``presto_tpu/ops/aggregate.py`` :600) and
``evaluate_classifier_predictions`` (:574), and their merge (:1176):

- REGRESSOR: over ``x_aug = [x, 1]`` (k features, ``dim = k + 1``) the
  ``dim * dim`` outer products ``x_aug[i] * x_aug[j]``, then
  ``x_aug[i] * y`` (``m = dim^2 + dim`` double lanes);
- CLASSIFIER: the label clipped to ``[0, C)``, its one-hot (C lanes),
  one-hot x x (C x k) and one-hot x x^2 (C x k), each a product as the
  reference's (``m = C (1 + 2k)``);
- EVALUATE: per class tp, fp, fn (3C int64 lanes) over the rows whose
  truth and prediction lie in ``[0, C)``;
- MERGE / MERGE_I64: partial state rows (double / int64), every column
  (the length slot too, as the reference sums the whole array).

A state is ``(groups, 1 + m)``: slot 0 the lane count ``m`` (a merge's
sum of its partials'), then the lanes' sums; beside it each group's
count of selected rows (a merge: the sum of the partials' counts).  A
feature is a matrix slot as a double, a NULL element 0.0.

Groups are addressed two ways.  Packed-direct (``slot``: each row's
slot, rows outside ``[0, groups)`` dropped; None: every selected row in
group 0) adds each slot's double lanes in K2's fixed order
(``packed_group_agg.chunk_sums_plain``): the rows in chunks of
``DSUM_CHUNK``, each chunk's rows in row order from 0.0, then the
chunk partials pairwise, level by level.  Runs (``order``, ``starts``:
each group's run of sorted positions, K6's; ``order`` None: positions
are rows) add K6's order (``sorted_group_agg.run_sums_plain``): chunks
of ``DSUM_CHUNK`` positions of a run, then pairwise.  The card and the
twin agree bit for bit.  Integer lanes and counts add in any order.
CUDA tensors launch ``csrc/ml_state.cu``; CPU tensors run
:func:`ml_state_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels.container_eval import ml_features
from presto_tpu_torch.kernels.packed_group_agg import DSUM_CHUNK, pairwise_levels
from presto_tpu_torch.kernels.sorted_group_agg import run_sums_plain

REGRESSOR, CLASSIFIER, EVALUATE, MERGE, MERGE_I64 = range(5)
MODE_NAMES = ("regressor", "classifier", "evaluate", "merge", "merge_i64")
C = 8  # ops/aggregate.ML_MAX_CLASSES
# the widest features a state takes (csrc/ml_state.cu K19_MAX_K), and
# the packed-direct table's limit: slots x lanes (K19_DIRECT_LANES)
MAX_K = 16
DIRECT_LANES = 4096
_FEATURE_DTYPES = (torch.int32, torch.int64, torch.float64)
_KINDS = {torch.int32: 1, torch.int64: 2, torch.float64: 3}

launches = 0
#: launches by mode name
mode_launches: dict = {}


def lanes(mode: int, k: int) -> int:
    """The lane count ``m`` of a partial state."""
    if mode == REGRESSOR:
        return (k + 1) * (k + 2)
    if mode == CLASSIFIER:
        return C * (1 + 2 * k)
    return 3 * C


def row_lanes(mode: int, k: int, label=None, y=None, feats=None,
              parts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lanes, in range)``: each row's ``(n, m)`` lanes (a merge's
    partial rows) and, for EVALUATE, whether truth and prediction lie in
    ``[0, C)`` (else every row)."""
    if mode in (MERGE, MERGE_I64):
        return parts, torch.ones(parts.shape[0], dtype=torch.bool, device=parts.device)
    if mode == EVALUATE:
        t, p = label[:, 0].to(torch.int64), label[:, 1].to(torch.int64)
        ok = (t >= 0) & (t < C) & (p >= 0) & (p < C)
        cls = torch.arange(C, device=t.device)[None, :]
        t_oh, p_oh, eq = t[:, None] == cls, p[:, None] == cls, (t == p)[:, None]
        out = torch.cat([t_oh & eq, p_oh & ~eq, t_oh & ~eq], 1).to(torch.int64)
        return out, ok
    x = ml_features(feats, k)
    n = x.shape[0]
    if mode == REGRESSOR:
        xa = torch.cat([x, torch.ones((n, 1), dtype=torch.float64, device=x.device)], 1)
        outer = (xa[:, :, None] * xa[:, None, :]).reshape(n, -1)
        return torch.cat([outer, xa * y[:, None]], 1), torch.ones(n, dtype=torch.bool,
                                                                 device=x.device)
    cls = torch.clamp(label.to(torch.int64), 0, C - 1)
    oh = (cls[:, None] == torch.arange(C, device=x.device)[None, :]).to(torch.float64)
    sumx = (oh[:, :, None] * x[:, None, :]).reshape(n, C * k)
    sumx2 = (oh[:, :, None] * (x * x)[:, None, :]).reshape(n, C * k)
    return torch.cat([oh, sumx, sumx2], 1), torch.ones(n, dtype=torch.bool, device=x.device)


def _direct_sums(v: torch.Tensor, slot: torch.Tensor, groups: int) -> torch.Tensor:
    """``chunk_sums_plain`` over the columns of ``v`` at once."""
    dev = v.device
    n, m = v.shape
    c = max(-(-n // DSUM_CHUNK), 1)
    pad = c * DSUM_CHUNK - n
    sv = torch.cat([slot, torch.full((pad,), groups, dtype=slot.dtype, device=dev)])
    xv = torch.cat([v, torch.zeros((pad, m), dtype=v.dtype, device=dev)])
    sv, xv = sv.view(c, DSUM_CHUNK), xv.view(c, DSUM_CHUNK, m)
    part = torch.zeros((c, groups + 1, m), dtype=torch.float64, device=dev)
    rows = torch.arange(c, device=dev)
    for j in range(DSUM_CHUNK):
        part[rows, sv[:, j]] = part[rows, sv[:, j]] + xv[:, j]
    return pairwise_levels(part[:, :groups])


def ml_state_plain(mode: int, groups: int, sel: torch.Tensor, k: int = 0, label=None, y=None,
                   feats=None, parts=None, counts=None, slot=None, order=None, starts=None):
    """The twin: ``(state, count)``."""
    dev = sel.device
    v, ok = row_lanes(mode, k, label, y, feats, parts)
    sel = sel & ok
    m = v.shape[1]
    ints = mode in (EVALUATE, MERGE_I64)
    cnt_in = counts if counts is not None else torch.ones_like(sel, dtype=torch.int64)
    if order is not None or starts is not None:  # runs
        rows = order[:int(starts[-1])] if order is not None else \
            torch.arange(int(starts[-1]), device=dev)
        g = torch.repeat_interleave(torch.arange(groups, device=dev), starts[1:] - starts[:-1])
        keep = sel[rows]
        vals = torch.where(keep[:, None], v[rows], torch.zeros((), dtype=v.dtype, device=dev))
        cnt = torch.zeros(groups, dtype=torch.int64, device=dev).index_add_(
            0, g, torch.where(keep, cnt_in[rows], torch.zeros_like(rows)))
        if ints:
            sums = torch.zeros((groups, m), dtype=torch.int64, device=dev).index_add_(0, g, vals)
        else:
            sums = run_sums_plain(vals, g, groups)
    else:
        s = torch.zeros_like(sel, dtype=torch.int64) if slot is None else slot
        s = torch.where(sel & (s >= 0) & (s < groups), s, torch.full_like(s, groups))
        cnt = torch.zeros(groups + 1, dtype=torch.int64, device=dev).index_add_(
            0, s, torch.where(sel, cnt_in, torch.zeros_like(cnt_in)))[:groups]
        if ints:
            sums = torch.zeros((groups + 1, m), dtype=torch.int64, device=dev).index_add_(
                0, s, v.to(torch.int64))[:groups]
        else:
            sums = _direct_sums(v, s, groups)
    if mode in (MERGE, MERGE_I64):
        return sums, cnt
    head = torch.full((groups, 1), m, dtype=sums.dtype, device=dev)
    return torch.cat([head, sums], 1), cnt


def ml_state(mode: int, groups: int, sel: torch.Tensor, k: int = 0,
             label: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
             feats: Optional[torch.Tensor] = None, parts: Optional[torch.Tensor] = None,
             counts: Optional[torch.Tensor] = None, slot: Optional[torch.Tensor] = None,
             order: Optional[torch.Tensor] = None, starts: Optional[torch.Tensor] = None):
    """``(state, count)`` of ``groups`` groups over the ``n`` rows whose
    ``sel`` is set.  REGRESSOR: ``y`` (n,) float64 and ``feats`` (n, 1 + k)
    int32/int64/float64 slots; CLASSIFIER: ``label`` (n,) int32/int64 and
    ``feats``; EVALUATE: ``label`` (n, 2) int64, truth then prediction;
    MERGE / MERGE_I64: ``parts`` (n, w) float64 / int64 partial states
    and ``counts`` (n,) int64.  Packed-direct by ``slot`` (n,) int64 or
    None, or runs by ``starts`` (groups + 1,) int64 and ``order`` (int64
    rows of the positions, or None).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches
    n = sel.shape[0]
    runs = order is not None or starts is not None
    if sel.dtype != torch.bool or sel.dim() != 1:
        raise ValueError("ml_state: sel must be (n,) bool")
    if not 0 <= mode < len(MODE_NAMES):
        raise ValueError(f"ml_state: mode {mode}")
    if mode in (REGRESSOR, CLASSIFIER):
        if feats is None or feats.dim() != 2 or feats.shape[0] != n \
                or feats.shape[1] < k + 1 or feats.dtype not in _FEATURE_DTYPES \
                or not 1 <= k <= MAX_K:
            raise ValueError(f"ml_state: features must be (n, 1 + k) int32/int64/float64, "
                             f"1 <= k <= {MAX_K}")
    if mode == REGRESSOR and (y is None or y.shape != (n,) or y.dtype != torch.float64):
        raise ValueError("ml_state: y must be (n,) float64")
    if mode == CLASSIFIER and (label is None or label.shape != (n,)
                               or label.dtype not in (torch.int32, torch.int64)):
        raise ValueError("ml_state: labels must be (n,) int32 or int64")
    if mode == EVALUATE and (label is None or label.shape != (n, 2)
                             or label.dtype != torch.int64):
        raise ValueError("ml_state: evaluate takes (n, 2) int64 truth and prediction")
    if mode in (MERGE, MERGE_I64):
        want = torch.float64 if mode == MERGE else torch.int64
        if parts is None or parts.dim() != 2 or parts.shape[0] != n or parts.dtype != want \
                or counts is None or counts.shape != (n,) or counts.dtype != torch.int64:
            raise ValueError("ml_state: a merge takes (n, w) partial states and (n,) int64 "
                             "counts")
    if runs and (starts is None or starts.shape != (groups + 1,) or starts.dtype != torch.int64
                 or (order is not None and order.dtype != torch.int64)):
        raise ValueError("ml_state: runs are (groups + 1,) int64 starts and int64 order")
    if slot is not None and (runs or slot.shape != (n,) or slot.dtype != torch.int64):
        raise ValueError("ml_state: slots are (n,) int64, and exclude runs")
    m = parts.shape[1] if mode in (MERGE, MERGE_I64) else lanes(mode, k)
    if not runs and groups * m > DIRECT_LANES:
        raise ValueError(f"ml_state: {groups} slots x {m} lanes past the direct table")
    if not sel.is_cuda:
        return ml_state_plain(mode, groups, sel, k, label, y, feats, parts, counts, slot,
                              order, starts)
    if label is not None and label.dtype == torch.int32:  # the kernel reads int64 labels
        label = label.to(torch.int64)
    tensors = [t for t in (sel, label, y, feats, parts, counts, slot, order, starts)
               if t is not None]
    build.require_cuda(tensors, "ml_state")
    dev = sel.device
    ints = mode in (EVALUATE, MERGE_I64)
    width = m if mode in (MERGE, MERGE_I64) else 1 + m
    state = torch.empty((groups, width), dtype=torch.int64 if ints else torch.float64,
                        device=dev)
    count = torch.empty(groups, dtype=torch.int64, device=dev)
    # chunk partials of the double lanes (one row of lanes per chunk and
    # slot): runs' chunks per group, or every chunk for every slot
    if runs:
        lens = starts[1:] - starts[:-1]
        nch = torch.div(lens + DSUM_CHUNK - 1, DSUM_CHUNK, rounding_mode="floor")
        chunk_lo = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                              torch.cumsum(nch, 0)])
        chunks = int(chunk_lo[-1])
    else:
        chunk_lo = None
        chunks = max(-(-n // DSUM_CHUNK), 1)
    scratch = torch.empty(1 if ints else max(chunks, 1) * (1 if runs else groups) * m,
                          dtype=torch.float64, device=dev)
    null = 0

    def ptr(t):
        return t.data_ptr() if t is not None else null

    fn = build.library().k19_ml_state
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int] + [ctypes.c_void_p] * 12 + \
        [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    err = fn(mode, n, groups, k, m, ptr(sel), ptr(label), ptr(y), ptr(feats), ptr(parts),
             ptr(counts), ptr(slot), ptr(order), ptr(starts), ptr(chunk_lo), ptr(state),
             ptr(count), feats.shape[1] if feats is not None else 0,
             _KINDS[feats.dtype] if feats is not None else 0, chunks, scratch.data_ptr(),
             build.stream_of(sel))
    build.check(err, "ml_state")
    launches += 1
    mode_launches[MODE_NAMES[mode]] = mode_launches.get(MODE_NAMES[mode], 0) + 1
    return state, count
