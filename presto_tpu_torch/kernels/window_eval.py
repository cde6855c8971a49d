"""K10 ``window_eval``: window functions over a page ordered for them.

``ops/window.py`` sorts a page by (partition, order) with the
reference's chain of stable sorts and hands the permutation here.
:func:`window_eval` computes everything the reference's
``window_page`` does after that sort (``presto_tpu/ops/window.py``):
the partition and peer boundaries, each row's segment start and last
row, its peer group's first and last row, every function kind of
``_compute_sorted`` over its frame, and the scatter back to the
original row order.  On CUDA tensors it launches
``csrc/window_eval.cu``; on CPU tensors it runs
:func:`window_eval_plain`, which is the reference's jnp code in torch.  A SMALLINT, TINYINT or REAL
argument keeps its storage (min/max, lead/lag, the value functions); a
REAL's sum and avg are doubles, as the reference's ``_window_sum_type``.

Inputs, all in the page's original row order: ``perm`` (sorted
position -> row, int64), the row mask, the packed or hashed partition
key (int64), the order keys' ``(data, valid)`` (only their equality
matters here: rows differ where any lane or the valid bit differs),
and one ``(data, valid)`` argument per function (None for the kinds
without one).  A function is a :class:`Func`: its kind, its frame
resolved to seg_start..last_peer (``FRAME_PEERS``, the default with
ORDER BY), the whole segment (``FRAME_WHOLE``) or signed row offsets
(``FRAME_ROWS``, None = unbounded), the lead/lag offset, ntile's bucket
count or nth_value's position, IGNORE NULLS, and for ``avg`` over a
decimal its scale.  Sums of an integer or short decimal are int64
(wrapping); a double's prefix sum adds in the order of the reference's
``jnp.cumsum`` on XLA:CPU (:func:`blocked_cumsum`), so its rows round
as the reference's, bit for bit; ``avg`` divides ``float64(sum)`` by
``10.0 ** scale`` and then by ``max(count, 1)``, both true divisions.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build

# function kinds: keep in step with csrc/window_eval.cu
ROW_NUMBER, RANK, DENSE_RANK, NTILE, PERCENT_RANK, CUME_DIST, LEAD, LAG, FIRST_VALUE, \
    LAST_VALUE, NTH_VALUE, COUNT, COUNT_STAR, SUM, AVG, MIN, MAX = range(17)
KIND_NAMES = ("row_number", "rank", "dense_rank", "ntile", "percent_rank", "cume_dist",
              "lead", "lag", "first_value", "last_value", "nth_value", "count",
              "count_star", "sum", "avg", "min", "max")
FRAME_PEERS, FRAME_WHOLE, FRAME_ROWS = range(3)
# storage kinds of order keys and arguments
KIND_BOOL, KIND_I32, KIND_I64, KIND_F64, KIND_I16, KIND_I8, KIND_F32 = 0, 1, 2, 3, 5, 6, 7
_KIND_OF = {torch.bool: KIND_BOOL, torch.int32: KIND_I32, torch.int64: KIND_I64,
            torch.float64: KIND_F64, torch.int16: KIND_I16, torch.int8: KIND_I8,
            torch.float32: KIND_F32}
_RANKS = (ROW_NUMBER, RANK, DENSE_RANK, NTILE, PERCENT_RANK, CUME_DIST)
_VALUES = (FIRST_VALUE, LAST_VALUE, NTH_VALUE)
MAX_ORDER = 8
SCAN_TILE = 2048  # csrc/scan.cuh SCAN_TILE
FSCAN_BLOCK = 16  # csrc/window_eval.cu K10_FSCAN_BLOCK
# a bound below every row offset a frame can name: None (unbounded) in C
_UNBOUNDED = -(1 << 62)

launches = 0
#: launches with a SMALLINT, TINYINT or REAL argument or order key
narrow_launches = 0
#: launches with an order key of several int64 lanes (a long decimal's
#: limbs, a raw varchar's lanes)
lanes_launches = 0
_NARROW = (torch.int16, torch.int8, torch.float32)

Lanes = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Func:
    kind: int
    frame: int = FRAME_WHOLE
    start: Optional[int] = None  # FRAME_ROWS: signed offset, None = unbounded
    end: Optional[int] = None
    offset: int = 1  # lead/lag offset; ntile buckets; nth_value position
    ignore_nulls: bool = False
    scale: Optional[int] = None  # avg over a decimal: divide by 10.0 ** scale


# a value of k int64 lanes (a long decimal's two limbs, a raw varchar's
# pack_lanes): its kind is KIND_LANES + k
KIND_LANES = 64
MAX_LANES = 128


def _kind_of(data: torch.Tensor) -> int:
    if data.dim() == 2:
        if data.dtype != torch.int64 or not data.is_contiguous() \
                or not 1 <= data.shape[1] <= MAX_LANES:
            raise ValueError(f"window_eval: lanes are (n, k <= {MAX_LANES}) int64")
        return KIND_LANES + data.shape[1]
    if data.dim() != 1 or data.dtype not in _KIND_OF:
        raise ValueError(f"window_eval: lanes of {data.dtype} {tuple(data.shape)}")
    return _KIND_OF[data.dtype]


def out_dtype(f: Func, arg: Optional[Lanes]) -> Tuple[torch.dtype, tuple]:
    """The output's dtype and value shape of ``f``."""
    if f.kind in (ROW_NUMBER, RANK, DENSE_RANK, NTILE, COUNT, COUNT_STAR):
        return torch.int64, ()
    if f.kind in (PERCENT_RANK, CUME_DIST, AVG):
        return torch.float64, ()
    if f.kind == SUM:  # a REAL sums in double
        return (torch.float64 if arg[0].is_floating_point() else torch.int64), ()
    return arg[0].dtype, tuple(arg[0].shape[1:])


# -- plain version ---------------------------------------------------------------

def _sel(mask: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    """``where`` over rows, broadcast across limbs."""
    if a.dim() > 1:
        mask = mask[:, None]
    return torch.where(mask, a, b)


def _first_true(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones(1, dtype=torch.bool, device=x.device), x])


def _rev_min_scan(flag: torch.Tensor, idx: torch.Tensor, cap: int) -> torch.Tensor:
    """The least position >= i where ``flag`` holds (cap - 1 if none)."""
    m = torch.where(flag.flip(0), idx.flip(0), torch.full_like(idx, cap - 1))
    return torch.cummin(m, 0).values.flip(0)


def _pick(minimum: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` / ``jnp.maximum``: a NaN operand wins, and -0.0 is
    below 0.0 (``torch.minimum`` ties the zeros)."""
    if not a.is_floating_point():
        return torch.minimum(a, b) if minimum else torch.maximum(a, b)
    sa = torch.signbit(a)
    take_a = (a < b if minimum else a > b) | ((a == b) & (sa if minimum else ~sa))
    r = torch.where(take_a, a, b)
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, r))


def _segmented_scan(minimum: bool, vals: torch.Tensor, seg_first: torch.Tensor):
    """Inclusive running min/max within segments (the reference's
    ``_segmented_scan``), by recursive doubling."""
    def op(a, b):
        return _pick(minimum, a, b)
    v, f = vals.clone(), seg_first.clone()
    s = 1
    while s < v.shape[0]:
        nv = torch.where(f[s:], v[s:], op(v[:-s], v[s:]))
        f = torch.cat([f[:s], f[s:] | f[:-s]])
        v = torch.cat([v[:s], nv])
        s *= 2
    return v


def _fill(dtype: torch.dtype, minimum: bool):
    """The running min/max's value for a NULL or dead row: the type's
    extreme (the largest finite double, as the reference's
    ``_type_max``).  The reference casts int64's extreme to an int32
    argument's storage, where it wraps (-1, 0); here an int32 argument
    takes int32's own, so NULLs never win."""
    if dtype == torch.float64:
        return torch.finfo(dtype).max if minimum else torch.finfo(dtype).min
    if dtype == torch.float32:  # the reference's int64 extreme as a REAL: 2^63
        return float(1 << 63) if minimum else -float(1 << 63)
    if dtype == torch.bool:
        return minimum
    info = torch.iinfo(dtype)
    return info.max if minimum else info.min


def window_eval_plain(perm: torch.Tensor, row_mask: torch.Tensor, pkey: torch.Tensor,
                      order_cols: Sequence[Lanes], funcs: Sequence[Func],
                      args: Sequence[Optional[Lanes]]) -> List[Lanes]:
    cap = perm.shape[0]
    dev = perm.device
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    live_s = row_mask[perm]
    pkey_s = pkey[perm]
    seg_first = _first_true(pkey_s[1:] != pkey_s[:-1]) | _first_true(live_s[1:] != live_s[:-1])
    peer_first = seg_first
    for d, v in order_cols:
        ds, vs = d[perm], v[perm]
        neq = ds[1:] != ds[:-1]
        if neq.dim() > 1:  # limb keys: rows differ if any limb differs
            neq = neq.any(-1)
        peer_first = peer_first | _first_true(neq | (vs[1:] != vs[:-1]))
    seg_start = torch.cummax(torch.where(seg_first, idx, 0), 0).values
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    last_peer = _rev_min_scan(torch.cat([peer_first[1:], true1]), idx, cap)
    seg_last = _rev_min_scan(torch.cat([seg_first[1:], true1]), idx, cap)
    ctx = (perm, idx, cap, live_s, seg_first, peer_first, seg_start, last_peer, seg_last)
    out = []
    for f, arg in zip(funcs, args):
        data_s, valid_s = _compute_sorted(f, arg, *ctx)
        data = torch.zeros_like(data_s)
        data[perm] = data_s
        valid = torch.zeros_like(valid_s)
        valid[perm] = valid_s & live_s
        out.append((data, valid))
    return out


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of float64 in XLA:CPU's order (its cumsum is
    a reduce-window that XLA rewrites into a scan of scans of 16):
    each run of 16 sums from 0.0 in order (the last run padded with
    0.0), the runs' totals scan the same way, and each run then adds
    the total of the runs before it."""
    n = x.shape[0]
    b = FSCAN_BLOCK
    if n <= b:  # in order, from 0.0, on every device
        out, acc = torch.empty_like(x), x.new_zeros(())
        for j in range(n):
            acc = acc + x[j]
            out[j] = acc
        return out
    rows = torch.cat([x, x.new_zeros(-n % b)]).reshape(-1, b)
    local = torch.empty_like(rows)
    acc = x.new_zeros(rows.shape[0])
    for j in range(b):
        acc = acc + rows[:, j]
        local[:, j] = acc
    inc = blocked_cumsum(acc)
    carry = torch.cat([x.new_zeros(1), inc[:-1]])
    return (local + carry[:, None]).reshape(-1)[:n]


def _nonnull_rank_index(vs, live_s, idx, cap):
    nonnull = vs & live_s
    grank = torch.cumsum(nonnull.to(torch.int64), 0)
    pos_of = torch.zeros(cap + 1, dtype=torch.int64, device=idx.device)
    pos_of[grank[nonnull]] = idx[nonnull]
    return nonnull, grank, pos_of


def _compute_sorted(f: Func, arg, perm, idx, cap, live_s, seg_first, peer_first, seg_start,
                    last_peer, seg_last):
    ones = torch.ones(cap, dtype=torch.bool, device=idx.device)
    if f.kind == ROW_NUMBER:
        return idx - seg_start + 1, ones
    if f.kind in (RANK, PERCENT_RANK):
        fp_pos = torch.cummax(torch.where(peer_first, idx, 0), 0).values
        if f.kind == RANK:
            return fp_pos - seg_start + 1, ones
        rank = (fp_pos - seg_start).to(torch.float64)
        count = (seg_last - seg_start).to(torch.float64)  # count - 1
        return torch.where(count > 0, rank / torch.clamp(count, min=1.0),
                           torch.zeros_like(rank)), ones
    if f.kind == DENSE_RANK:
        cum = torch.cumsum(peer_first.to(torch.int64), 0)
        return cum - cum[seg_start] + 1, ones
    if f.kind == NTILE:
        n = f.offset
        rn0 = idx - seg_start
        count = seg_last - seg_start + 1
        q, r = torch.div(count, n, rounding_mode="floor"), torch.remainder(count, n)
        big = (q + 1) * r
        bucket = torch.where(rn0 < big,
                             torch.div(rn0, torch.clamp(q + 1, min=1), rounding_mode="floor"),
                             r + torch.div(rn0 - big, torch.clamp(q, min=1),
                                           rounding_mode="floor"))
        return bucket + 1, ones
    if f.kind == CUME_DIST:
        covered = (last_peer - seg_start + 1).to(torch.float64)
        count = (seg_last - seg_start + 1).to(torch.float64)
        return covered / torch.clamp(count, min=1.0), ones

    if f.kind in (LEAD, LAG):
        ds, vs = arg[0][perm], arg[1][perm]
        if f.ignore_nulls and f.offset > 0:
            nonnull, grank, pos_of = _nonnull_rank_index(vs, live_s, idx, cap)
            if f.kind == LAG:
                tgt = grank - nonnull.to(torch.int64) - (f.offset - 1)
            else:
                tgt = grank + f.offset
            exists = (tgt >= 1) & (tgt <= grank[-1])
            src_c = pos_of[torch.clamp(tgt, 0, cap)]
            ok = exists & (seg_start[src_c] == seg_start)
            return _sel(ok, ds[src_c], torch.zeros_like(ds)), ok
        src = idx + (-f.offset if f.kind == LAG else f.offset)
        in_range = (src >= 0) & (src < cap)
        src_c = torch.clamp(src, 0, cap - 1)
        ok = in_range & (seg_start[src_c] == seg_start)
        return _sel(ok, ds[src_c], torch.zeros_like(ds)), ok & vs[src_c]

    if f.frame == FRAME_ROWS:
        f_start = seg_start if f.start is None else torch.maximum(seg_start, idx + f.start)
        f_end = seg_last if f.end is None else torch.minimum(seg_last, idx + f.end)
    elif f.frame == FRAME_WHOLE:
        f_start, f_end = seg_start, seg_last
    else:
        f_start, f_end = seg_start, last_peer
    empty = f_end < f_start
    s_c = torch.clamp(f_start, 0, cap - 1)
    e_c = torch.clamp(f_end, 0, cap - 1)

    if f.kind in _VALUES:
        ds, vs = arg[0][perm], arg[1][perm]
        if f.ignore_nulls:
            nonnull, grank, pos_of = _nonnull_rank_index(vs, live_s, idx, cap)
            before = grank[s_c] - nonnull[s_c].to(torch.int64)
            in_frame = grank[e_c] - before
            if f.kind == FIRST_VALUE:
                want = before + 1
            elif f.kind == LAST_VALUE:
                want = grank[e_c]
            else:
                want = before + f.offset
            have = ~empty & (want > before) & (want <= grank[e_c]) & (in_frame > 0)
            pos = pos_of[torch.clamp(want, 0, cap)]
            return _sel(have, ds[pos], torch.zeros_like(ds)), have
        if f.kind == FIRST_VALUE:
            pos = s_c
        elif f.kind == LAST_VALUE:
            pos = e_c
        else:
            pos = torch.clamp(f_start + (f.offset - 1), 0, cap - 1)
            empty = empty | (f_start + (f.offset - 1) > f_end)
        return ds[pos], vs[pos] & ~empty

    if f.kind == COUNT_STAR:
        vcount = live_s
    else:
        ds, vs = arg[0][perm], arg[1][perm] & live_s
        vcount = vs

    def frame_sum(vals):
        p = blocked_cumsum(vals) if vals.is_floating_point() else torch.cumsum(vals, 0)
        out = p[e_c] - p[s_c] + vals[s_c]
        return torch.where(empty, torch.zeros_like(out), out)

    cnt = frame_sum(vcount.to(torch.int64))
    if f.kind in (COUNT, COUNT_STAR):
        return cnt, ones
    if f.kind in (SUM, AVG):
        st = torch.float64 if ds.is_floating_point() else torch.int64  # a REAL as float64
        vals = torch.where(vs, ds.to(st), torch.zeros((), dtype=st, device=ds.device))
        s_out = frame_sum(vals)
        if f.kind == SUM:
            return s_out, cnt > 0
        num = s_out.to(torch.float64)
        if f.scale is not None:  # true divisions, as the kernel's
            num = num / torch.tensor(10.0 ** f.scale, dtype=torch.float64, device=num.device)
        return num / torch.clamp(cnt, min=1).to(torch.float64), cnt > 0
    if f.kind in (MIN, MAX):
        vals = torch.where(vs, ds, torch.full_like(ds, _fill(ds.dtype, f.kind == MIN)))
        m = _segmented_scan(f.kind == MIN, vals, seg_first)
        return m[e_c], cnt > 0
    raise KeyError(f.kind)


# -- dispatch ----------------------------------------------------------------------

def window_eval(perm: torch.Tensor, row_mask: torch.Tensor, pkey: torch.Tensor,
                order_cols: Sequence[Lanes], funcs: Sequence[Func],
                args: Sequence[Optional[Lanes]]) -> List[Lanes]:
    """Each function's ``(data, valid)`` in the original row order (valid
    only on live rows).  An order key or argument of (n, k) int64 lanes
    (a long decimal, a raw varchar's ``pack_lanes``) is one value a row.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    for f, a in zip(funcs, args):
        if f.kind in (SUM, AVG, MIN, MAX) and a[0].dim() > 1:
            raise ValueError(f"window_eval: {KIND_NAMES[f.kind]} over long decimals")
    if not perm.is_cuda:
        return window_eval_plain(perm, row_mask, pkey, order_cols, funcs, args)
    return _launch(perm, row_mask, pkey, order_cols, funcs, args)


def _launch(perm, row_mask, pkey, order_cols, funcs, args):
    global launches, narrow_launches, lanes_launches
    n = perm.shape[0]
    if perm.dtype != torch.int64 or perm.dim() != 1 or row_mask.dtype != torch.bool \
            or row_mask.shape != (n,) or pkey.dtype != torch.int64 or pkey.shape != (n,):
        raise ValueError("window_eval: perm (n,) int64, row_mask (n,) bool, pkey (n,) int64")
    if len(order_cols) > MAX_ORDER or n >= (1 << 31) - 1:
        raise ValueError("window_eval: at most 8 order keys and 2^31 - 2 rows")
    tensors = [perm, row_mask, pkey]
    order_kinds = []
    for d, v in order_cols:
        order_kinds.append(_kind_of(d))
        if d.shape[0] != n or v.shape != (n,) or v.dtype != torch.bool:
            raise ValueError("window_eval: order keys must have the page's rows")
        tensors += [d, v]
    for f, a in zip(funcs, args):
        if (a is None) != (f.kind in _RANKS or f.kind == COUNT_STAR):
            raise ValueError(f"window_eval: {KIND_NAMES[f.kind]} argument")
        if a is not None:
            _kind_of(a[0])
            if a[0].shape[0] != n or a[1].shape != (n,) or a[1].dtype != torch.bool:
                raise ValueError("window_eval: arguments must have the page's rows")
            tensors += list(a)
        if f.kind in (NTILE, NTH_VALUE) and f.offset < 1 or f.offset < 0:
            raise ValueError(f"window_eval: {KIND_NAMES[f.kind]} offset {f.offset}")
    build.require_cuda(tensors, "window_eval")
    dev = perm.device
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    outs = []
    for f, a in zip(funcs, args):
        dtype, tail = out_dtype(f, a)
        outs.append((torch.empty((n,) + tail, dtype=dtype, device=dev),
                     torch.empty(n, dtype=torch.bool, device=dev)))
    # scratch (csrc/window_eval.cu k10_window_eval): the boundary counts,
    # the starts they index, a count scan, IGNORE NULLS's rank ->
    # position table, the values to sum or scan and their prefix, and
    # the scans' per-tile partials
    int_scratch = [torch.empty(n + 1, **i32) for _ in range(6)]
    vals, scan = torch.empty(n + 1, **i64), torch.empty(n + 1, **i64)
    # a double prefix sum's upper levels: the totals of each run of 16
    levels = torch.empty(n // (FSCAN_BLOCK - 1) + 64, **i64)
    partials = torch.empty(2 * (-(-n // SCAN_TILE) + 1), **i64)
    # per function: kind, frame, start, end, offset, ignore_nulls,
    # scale (-1: none), argument kind (-1: none)
    desc = []
    for f, a in zip(funcs, args):
        desc += [f.kind, f.frame, _UNBOUNDED if f.start is None else f.start,
                 _UNBOUNDED if f.end is None else f.end, f.offset, int(f.ignore_nulls),
                 -1 if f.scale is None else f.scale, -1 if a is None else _kind_of(a[0])]
    fn = build.library().k10_window_eval
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 16
    # the C arrays stay referenced until the call returns
    c_desc = build.ptrs(desc)
    c_od = build.ptrs(d.data_ptr() for d, _ in order_cols)
    c_ov = build.ptrs(v.data_ptr() for _, v in order_cols)
    c_ok = build.ints(order_kinds)
    c_ad = build.ptrs(0 if a is None else a[0].data_ptr() for a in args)
    c_av = build.ptrs(0 if a is None else a[1].data_ptr() for a in args)
    c_outd = build.ptrs(o[0].data_ptr() for o in outs)
    c_outv = build.ptrs(o[1].data_ptr() for o in outs)
    err = fn(n, perm.data_ptr(), row_mask.data_ptr(), pkey.data_ptr(),
             len(order_cols), c_od, c_ov, c_ok,
             len(funcs), c_desc, c_ad, c_av, c_outd, c_outv,
             *[t.data_ptr() for t in int_scratch], vals.data_ptr(), scan.data_ptr(),
             levels.data_ptr(), partials.data_ptr(), build.stream_of(perm))
    build.check(err, "window_eval")
    launches += 1
    lanes_launches += int(any(d.dim() > 1 for d, _ in order_cols))
    narrow_launches += int(any(d.dtype in _NARROW for d, _ in order_cols)
                           or any(a is not None and a[0].dtype in _NARROW for a in args))
    return outs
