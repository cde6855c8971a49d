"""K12 ``container_eval``: the per-row slot functions of ARRAY, MAP and ROW.

A container value is a row of a ``(n, 1 + slots)`` matrix (see
``ops/container.py``).  Each function here takes such matrices and
scalar lanes (K1's ``(data, valid)`` outputs) and gives a matrix or a
scalar lane; on a CUDA tensor it launches ``csrc/container_eval.cu``
(one thread per row over its slots, an opcode per function), on a CPU
tensor it runs the plain twin, which computes the same values with
whole-tensor torch ops.  The semantics are the reference's
(``presto_tpu/ops/container.py`` and ``_compile_container`` in
``presto_tpu/expr/compile.py``):

- lengths read slot 0, a NaN or negative length as 0; an element slot
  is live below the length and NULL where it holds the sentinel;
- ``subscript`` (1-based) and ``map_get`` give NULL out of range or on
  a missing key (element_at's rule, for ``[]`` too); ``map_get`` takes
  the first entry with the key (duplicate keys stay separate entries);
- ``reduce`` (array_min/max/sum/average) folds the live non-NULL
  elements in slot order (a double sum adds in that order from 0.0);
- ``sort`` and ``distinct`` give the non-NULL elements in ascending
  order (stable; NULL elements last for ``sort``; ``distinct`` keeps one
  of each value, in sorted order, plus one NULL when the array held
  one); pads are told from real extremes by position, never by value;
- ``coerce`` converts slots between element types as the reference's
  ``coerce_slots`` (decimal rescales, a double to a decimal half to
  even), NULL kept as the new storage's sentinel;
- the lambda functions read their body's K1 output over the flattened
  elements (K13 ``unnest_expand``, one lane per live element, element
  ``j`` of row ``r`` at ``offsets[r] + j``): ``assemble`` (transform,
  zip_with, transform_values), ``compact`` and ``compact_pairs``
  (filter, map_filter, order kept), ``transform_keys`` (a NULL new key
  drops its entry, a repeated one keeps the first) and ``match``
  (any_match, none_match, all_match; all_match counts a NULL body as
  false, the reference's rule);
- the sketches (int64 rows ``[count, 512 buckets, 512 rho]`` of a
  HYPERLOGLOG, ``[len, 64 hashes, 64 counts]`` of a SETDIGEST; the
  reference's ``cardinality`` branches and ``jaccard_index`` /
  ``intersection_cardinality`` in ``_compile_container``):
  ``hll_card`` sums the weights ``2^-rho`` of the present registers
  (exact powers of two, where the reference's XLA ``exp2`` is a few ulp
  off: the rounded estimate moves only at a .5 boundary) lane by lane
  as the kernel's warp does, then the linear-counting correction;
  ``kmv_card`` the KMV estimate; ``sd_pair`` the minhash comparison of
  two digests over their union's 64 smallest distinct hashes;
- the ML models (the reference's ``_compile_ml``): ``regress`` gives a
  row's ``sum_j w[j] * x[j]`` in slot order from 0.0, then ``+ w[k]``;
  ``classify`` the first class of greatest Gaussian naive Bayes
  log-likelihood (prior and variances clamped at 1e-12), a NaN counting
  as the greatest as ``jnp.argmax``; a NULL feature is 0.0.  The logs
  are the card's ``log`` and torch's, within 2 ulp of each other, so a
  class may differ where two log-likelihoods lie that close
  (:func:`classify_ll_plain` gives every class's);
- ``setop`` (array_intersect / array_except before ``distinct``),
  ``overlap`` (three-valued) and ``remove`` compare in the common type,
  ``map_concat`` lets the last map's key win.

Storage dtypes are int32, int64 and float64; a CUDA tensor of another
dtype, or an opcode the kernel lacks, raises (the C entry refuses it).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Sequence

import torch

from presto_tpu_torch.kernels import build

# opcodes: keep in step with csrc/container_eval.cu
CARD, SUBSCRIPT, MAP_GET, CONTAINS, POSITION, REDUCE, SORT, DISTINCT, SLICE, COERCE, \
    CONCAT, MAP_HALF, CONSTRUCT, CONSTRUCT_MAP, ROW_FIELD, COMPACT, COMPACT_PAIRS, SETOP, \
    OVERLAP, REMOVE, MAP_CONCAT, TKEYS, SEQUENCE, REPEAT, ASSEMBLE, MATCH, SLOT, \
    TABLE, HLL_CARD, KMV_CARD, SD_PAIR, REGRESS, CLASSIFY = range(33)
OP_NAMES = ("card", "subscript", "map_get", "contains", "position", "reduce", "sort",
            "distinct", "slice", "coerce", "concat", "map_half", "construct",
            "construct_map", "row_field", "compact", "compact_pairs", "setop", "overlap",
            "remove", "map_concat", "transform_keys", "sequence", "repeat", "assemble",
            "match", "slot", "table", "hll_card", "kmv_card", "sd_pair", "regress",
            "classify")
# SD_PAIR's result: jaccard_index (a double) or intersection_cardinality
SD_JACCARD, SD_INTERSECTION = range(2)
# REDUCE's function, MATCH's test, SETOP's operation
R_MIN, R_MAX, R_SUM, R_AVG = range(4)
M_ANY, M_NONE, M_ALL = range(3)
S_INTERSECT, S_EXCEPT = range(2)
# COERCE's conversions (the reference's coerce_slots): a plain cast, a
# decimal to a double (divide by 10^scale), a double to a decimal
# (round(x * 10^scale), half to even), a decimal up-scale (times 10^k,
# wrapping) or down-scale (floor division by 10^k); or the reference's
# plain astype, which keeps NULL only where the storages agree (an
# integer sentinel into a double is its value, a NaN into an integer
# that type's least value)
C_CAST, C_DEC2DBL, C_DBL2DEC, C_UP, C_DOWN, C_ASTYPE = range(6)

# dtype codes of an operand (csrc/container_eval.cu K12_BOOL ...)
_KIND = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float64: 3}
STORAGE = (torch.int32, torch.int64, torch.float64)

launches = 0
#: launches by opcode name
op_launches: dict = {}

# ---------------------------------------------------------------------------
# shared element rules
# ---------------------------------------------------------------------------

def sentinel(dtype: torch.dtype):
    return float("nan") if dtype.is_floating_point else torch.iinfo(dtype).min


def is_null(x: torch.Tensor) -> torch.Tensor:
    """True where a slot holds the NULL sentinel."""
    if x.is_floating_point():
        return torch.isnan(x)
    return x == torch.iinfo(x.dtype).min


def lengths(a: torch.Tensor) -> torch.Tensor:
    """Slot 0 as an int64 length (NaN or negative: 0)."""
    l0 = a[:, 0]
    if l0.is_floating_point():
        l0 = torch.where(torch.isnan(l0), torch.zeros_like(l0), l0)
    return torch.clamp(l0.to(torch.int64), min=0)


def cast_values(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``, a NULL slot (or a NaN) as the new sentinel; a
    double into an integer truncates."""
    null = is_null(x) if x.dtype != torch.bool else torch.zeros_like(x)
    if x.is_floating_point() and not dtype.is_floating_point:
        x = torch.where(null, torch.zeros_like(x), x)
    out = x.to(dtype)
    return torch.where(null, torch.full_like(out, sentinel(dtype)), out)


def astype_values(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """numpy's ``astype`` as the reference's host runs it: a NaN into an
    integer gives that type's least value, everything else a plain cast."""
    if x.is_floating_point() and not dtype.is_floating_point:
        nan = torch.isnan(x)
        out = torch.where(nan, torch.zeros_like(x), x).to(dtype)
        return torch.where(nan, torch.full_like(out, torch.iinfo(dtype).min), out)
    return x.to(dtype)


def _jj(m: int, device) -> torch.Tensor:
    return torch.arange(m, device=device)[None, :]


def _full(n: int, m: int, dtype, device) -> torch.Tensor:
    return torch.full((n, m), sentinel(dtype), dtype=dtype, device=device)


def _gather(slots: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``slots[r, idx[r, j]]``, the sentinel where the matrix has no slot."""
    n, w = slots.shape
    if w == 0:
        return _full(n, idx.shape[1], slots.dtype, slots.device)
    return torch.gather(slots, 1, torch.clamp(idx, 0, w - 1))


def _fit(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x`` cut or padded with the sentinel to ``m`` columns."""
    if x.shape[1] >= m:
        return x[:, :m]
    return torch.cat([x, _full(x.shape[0], m - x.shape[1], x.dtype, x.device)], 1)


def _row_compact(slots: torch.Tensor, keep: torch.Tensor, cap: int) -> torch.Tensor:
    """Order-preserving per-row compaction of the kept slots into a
    ``[len, values...]`` matrix of ``cap`` value slots (the reference's
    ``_row_compact``)."""
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    comp = _fit(torch.gather(slots, 1, order) if slots.shape[1] else slots, cap)
    k = torch.clamp(keep.sum(1), max=cap)
    vals = torch.where(_jj(cap, slots.device) < k[:, None], comp,
                       torch.full_like(comp, sentinel(slots.dtype)))
    return torch.cat([k[:, None].to(slots.dtype), vals], 1)


def _pair_compact(ks: torch.Tensor, vs: torch.Tensor, keep: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """The reference's ``compact_entry_pairs``: kept (key, value) pairs
    compacted in order into a ``[len, keys..., values...]`` map."""
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    k = torch.clamp(keep.sum(1), max=cap)
    live = _jj(cap, ks.device) < k[:, None]
    sent = torch.full((1,), sentinel(ks.dtype), dtype=ks.dtype, device=ks.device)
    kc = torch.where(live, _fit(torch.gather(ks, 1, order) if ks.shape[1] else ks, cap), sent)
    vc = torch.where(live, _fit(torch.gather(vs, 1, order) if vs.shape[1] else vs, cap), sent)
    return torch.cat([k[:, None].to(ks.dtype), kc, vc], 1)


def _flat(off: torch.Tensor, yd: torch.Tensor, yv: torch.Tensor, m: int):
    """Element ``j`` of row ``r`` of a flattened body (``offsets[r] +
    j``) as ``(n, m)`` matrices: data, valid, and in-range."""
    cnt = off[1:] - off[:-1]
    j = _jj(m, off.device)
    inb = j < cnt[:, None]
    total = yd.shape[0]
    idx = torch.clamp(off[:-1, None] + j, 0, max(total - 1, 0))
    if total == 0:
        return (torch.zeros((cnt.shape[0], m), dtype=yd.dtype, device=off.device),
                torch.zeros((cnt.shape[0], m), dtype=torch.bool, device=off.device), inb)
    return yd[idx], yv[idx] & inb, inb


def conv_slots(x: torch.Tensor, dtype: torch.dtype, mode: int, factor) -> torch.Tensor:
    """One COERCE conversion of a slot block into ``dtype``."""
    if mode == C_ASTYPE:
        return astype_values(x, dtype)
    null = is_null(x)
    if mode == C_CAST:
        return cast_values(x, dtype)
    xs = torch.where(null, torch.zeros_like(x), x)
    if mode == C_DEC2DBL:
        out = xs.to(torch.float64) / factor
    elif mode == C_DBL2DEC:
        out = torch.round(xs.to(torch.float64) * factor)
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out)).to(torch.int64)
    elif mode == C_UP:
        out = xs.to(torch.int64) * int(factor)
    else:
        out = torch.div(xs.to(torch.int64), int(factor), rounding_mode="floor")
    out = out.to(dtype)
    return torch.where(null, torch.full_like(out, sentinel(dtype)), out)


def lane_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A K1 lane in a storage dtype (a double's NaN as the int sentinel)."""
    if x.dtype == torch.bool:
        return x.to(dtype)
    return cast_values(x, dtype)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def plain(op: int, a=None, av=None, b=None, bv=None, c=None, x=None, xv=None, y=None,
          yv=None, off=None, out_m=0, out_dtype=None, p=()):
    """The twin of one K12 opcode (arguments as :func:`container_eval`)."""
    p = list(p) + [0] * (6 - len(p))
    if op == SEQUENCE:  # x: any (n,) lane, for the row count and device
        n, lo, step = x.shape[0], p[0], p[1]
        row = torch.cat([torch.tensor([out_m], dtype=torch.int64),
                         lo + step * torch.arange(out_m, dtype=torch.int64)]).to(x.device)
        return row[None, :].expand(n, out_m + 1).contiguous()
    if op == REPEAT:
        e = torch.where(xv, lane_to(x, out_dtype), torch.full_like(lane_to(x, out_dtype),
                                                                  sentinel(out_dtype)))
        n = x.shape[0]
        return torch.cat([torch.full((n, 1), p[0], dtype=out_dtype, device=x.device),
                          e[:, None].expand(n, out_m)], 1)
    if op == CONSTRUCT:
        n, k = y.shape
        vals = torch.where(yv, y, torch.full_like(y, sentinel(y.dtype)))
        parts = [torch.full((n, 1), k, dtype=y.dtype, device=y.device)] if p[0] else []
        return torch.cat(parts + [_fit(vals, out_m)], 1)
    if op == ASSEMBLE:
        cnt = off[1:] - off[:-1]
        yd_m, ok, inb = _flat(off, y, yv, out_m)
        vals = torch.where(ok, yd_m, torch.full_like(yd_m, sentinel(y.dtype)))
        parts = [cnt[:, None].to(y.dtype)]
        if p[0]:  # transform_values: the map's keys (p[1]: its storage code)
            parts.append(astype_values(a[:, 1:1 + out_m], y.dtype))
        return torch.cat(parts + [vals], 1)
    if op == MATCH:
        m = p[1]
        yd_m, ok, inb = _flat(off, y, yv, m)
        hit = ok & yd_m
        if p[0] == M_ANY:
            out = hit.any(1)
        elif p[0] == M_NONE:
            out = ~hit.any(1)
        else:
            out = torch.where(inb, hit, torch.ones_like(hit)).all(1)
        return out, av.clone()
    if op == TABLE:
        codes = torch.clamp(x.to(torch.int64), 0, a.shape[0] - 1)
        return a[codes], xv.clone()
    if op in (HLL_CARD, KMV_CARD, SD_PAIR):
        return _sketch_plain(op, a, av, b, bv, p)
    if op in (REGRESS, CLASSIFY):
        return _ml_plain(op, a, av, b, bv, p)
    n = a.shape[0]
    dev = a.device
    T = a.dtype
    L = lengths(a)
    if op == CARD:
        return L, av.clone() if av is not None else torch.ones_like(L, dtype=torch.bool)
    if op == ROW_FIELD:
        g = a[:, p[0]]
        return g.clone(), av & ~is_null(g)
    m = p[5] if op in (MAP_GET, COMPACT_PAIRS, TKEYS, MAP_HALF, MAP_CONCAT, COERCE) \
        else a.shape[1] - 1
    slots = a[:, 1:1 + m]
    j = _jj(m, dev)
    live = j < L[:, None]
    null = is_null(slots)
    if op == SUBSCRIPT:
        i0 = x.to(torch.int64) - 1
        ok = xv & (i0 >= 0) & (i0 < L)
        g = _gather(slots, i0[:, None])[:, 0]
        return g, av & ok & ~is_null(g)
    if op == MAP_GET:
        vals = a[:, 1 + m:1 + 2 * m]
        key = lane_to(x, T)
        hit = live & (slots == key[:, None]) & xv[:, None]
        first = torch.argmax(hit.to(torch.int8), 1) if m else torch.zeros(n, dtype=torch.int64,
                                                                          device=dev)
        v = _gather(vals, first[:, None])[:, 0]
        return v, av & hit.any(1) & ~is_null(v)
    if op in (CONTAINS, POSITION):
        key = lane_to(x, T)
        hit = live & ~null & (slots == key[:, None])
        if op == CONTAINS:
            return hit.any(1), av & xv
        pos = torch.where(hit.any(1), torch.argmax(hit.to(torch.int8), 1) + 1
                          if m else torch.zeros(n, dtype=torch.int64, device=dev),
                          torch.zeros(n, dtype=torch.int64, device=dev))
        return pos.to(torch.int64), av & xv
    if op == REDUCE:
        ok = live & ~null
        cnt = ok.sum(1)
        mode = p[0]
        if mode in (R_MIN, R_MAX):
            if T.is_floating_point:
                fill = float("inf") if mode == R_MIN else float("-inf")
            else:
                info = torch.iinfo(T)
                fill = info.max if mode == R_MIN else info.min + 1
            acc = torch.full((n,), fill, dtype=T, device=dev)
            for jj in range(m):
                v = slots[:, jj]
                better = v < acc if mode == R_MIN else v > acc
                acc = torch.where(ok[:, jj] & better, v, acc)
            return acc, av & (cnt > 0)
        acc = torch.zeros(n, dtype=T, device=dev)
        for jj in range(m):
            acc = acc + torch.where(ok[:, jj], slots[:, jj], torch.zeros_like(acc))
        if mode == R_AVG:
            acc = acc.to(torch.float64) / torch.clamp(cnt, min=1).to(torch.float64)
        return acc, av & (cnt > 0)
    if op in (SORT, DISTINCT):
        nnm = live & ~null
        nn = nnm.sum(1)
        pad = float("nan") if T.is_floating_point else torch.iinfo(T).max
        key = torch.where(nnm, slots, torch.full_like(slots, pad))
        if op == SORT and not T.is_floating_point:
            # the reference's integer sort key: a NULL element as max - 1,
            # between the values and the pads (so a real max beside a
            # NULL comes out as max - 1: its fault, followed)
            key = torch.where(live & null, torch.full_like(key, pad - 1), key)
        s = torch.sort(key, dim=1, stable=True).values
        sent = torch.full_like(s, sentinel(T))
        if op == SORT:
            return torch.cat([a[:, :1], torch.where(j < nn[:, None], s, sent)], 1)
        keep = torch.ones_like(nnm)
        keep[:, 1:] = s[:, 1:] != s[:, :-1]
        keep &= j < nn[:, None]
        comp = _row_compact(s, keep, m)
        had_null = (live & null).any(1)
        comp[:, 0] = (keep.sum(1) + had_null.to(torch.int64)).to(T)
        return comp
    if op == SLICE:
        start, length = p[0], p[1]
        base = torch.full_like(L, start - 1) if start > 0 else torch.clamp(L + start, min=0)
        avail = torch.clamp(torch.minimum(L - base, torch.full_like(L, length)), min=0)
        g = _gather(slots, j + base[:, None])
        out = torch.where(j < avail[:, None], g, torch.full_like(g, sentinel(T)))
        return torch.cat([avail[:, None].to(T), out], 1)
    if op == COERCE:
        kmode, kfac, vmode, vfac, is_map = p[0], _factor(p[0], p[1]), p[2], _factor(p[2], p[3]), \
            p[4]
        parts = [astype_values(a[:, :1], out_dtype), conv_slots(slots, out_dtype, kmode, kfac)]
        if is_map:
            parts.append(conv_slots(a[:, 1 + m:1 + 2 * m], out_dtype, vmode, vfac))
        return torch.cat(parts, 1)
    if op == MAP_HALF:
        half = a[:, 1 + p[0] * m:1 + (p[0] + 1) * m]
        return torch.cat([L[:, None].to(out_dtype), astype_values(half, out_dtype)], 1)
    if op == CONCAT:
        lb = lengths(b)
        sb = b[:, 1:]
        bj = _jj(out_m, dev) - L[:, None]
        b_vals = _gather(sb, bj)
        jo = _jj(out_m, dev)
        out = torch.where(jo < L[:, None], _fit(slots, out_m), b_vals)
        total = L + lb
        out = torch.where(jo < total[:, None], out, torch.full_like(out, sentinel(T)))
        return torch.cat([total[:, None].to(T), out], 1)
    if op == CONSTRUCT_MAP:
        k = torch.minimum(L, lengths(b))
        jo = _jj(out_m, dev)
        livem = jo < k[:, None]
        sent = torch.full((1,), sentinel(T), dtype=T, device=dev)
        keys = torch.where(livem, _fit(slots, out_m), sent)
        vals = torch.where(livem, _fit(b[:, 1:], out_m), sent)
        return torch.cat([k[:, None].to(T), keys, vals], 1)
    if op == COMPACT:
        yd_m, ok, _ = _flat(off, y, yv, m)
        return _row_compact(slots, ok & yd_m, out_m)
    if op == COMPACT_PAIRS:
        yd_m, ok, _ = _flat(off, y, yv, m)
        return _pair_compact(slots, a[:, 1 + m:1 + 2 * m], ok & yd_m, out_m)
    if op == TKEYS:
        newk, ok, _ = _flat(off, y, yv, m)
        newk = torch.where(ok, newk, torch.full_like(newk, sentinel(T)))
        earlier = torch.triu(torch.ones((m, m), dtype=torch.bool, device=dev), 1)
        eq = newk[:, :, None] == newk[:, None, :]
        dup = (eq & ok[:, :, None] & earlier[None]).any(1)
        return _pair_compact(newk, a[:, 1 + m:1 + 2 * m], ok & ~dup, out_m)
    if op in (SETOP, OVERLAP):
        # b and c: b and a in the comparison type (coerced beforehand)
        sac = c[:, 1:1 + m]
        mb = b.shape[1] - 1
        sbc = b[:, 1:1 + mb]
        lb = _jj(mb, dev) < lengths(b)[:, None]
        nb = is_null(sbc)
        member = ((sac[:, :, None] == sbc[:, None, :]) & (lb & ~nb)[:, None, :]).any(2)
        b_null = (lb & nb).any(1)
        if op == OVERLAP:
            match = (live & ~null & member).any(1)
            a_null = (live & null).any(1)
            return match, av & bv & (match | ~(a_null | b_null))
        if p[0] == S_INTERSECT:
            keep = live & ((~null & member) | (null & b_null[:, None]))
        else:
            keep = live & ((~null & ~member) | (null & ~b_null[:, None]))
        return _row_compact(slots, keep, out_m)
    if op == REMOVE:
        key = lane_to(x, T)
        keep = live & (null | (slots != key[:, None]))
        return _row_compact(slots, keep, m), av & xv
    if op == MAP_CONCAT:
        m2 = p[4]
        k2 = b[:, 1:1 + m2]
        live2 = _jj(m2, dev) < lengths(b)[:, None]
        shadowed = ((slots[:, :, None] == k2[:, None, :]) & live2[:, None, :]).any(2)
        ks = torch.cat([slots, k2], 1)
        vs = torch.cat([a[:, 1 + m:1 + 2 * m], b[:, 1 + m2:1 + 2 * m2]], 1)
        return _pair_compact(ks, vs, torch.cat([live & ~shadowed, live2], 1), out_m)
    if op == SLOT:
        i = p[0]
        v = a[:, 1 + i] if i < m else torch.full((n,), sentinel(T), dtype=T, device=dev)
        lv = i < L
        return v.clone(), lv & ~is_null(v), lv
    raise ValueError(f"container_eval: opcode {op}")


def rho_weights(rho: torch.Tensor) -> torch.Tensor:
    """``2^-rho`` as a double, exact from its bits for rho in 0..1022."""
    bits = torch.clamp(1023 - rho, 1, 1023) << 52
    return torch.where((rho >= 0) & (rho <= 1022), bits.view(torch.float64),
                       torch.exp2(-rho.to(torch.float64)))


def kmv_estimate(k: int, kth: torch.Tensor) -> torch.Tensor:
    """``(K - 1) / fraction`` of the hash space below ``kth`` (a double)."""
    frac = torch.clamp(kth.to(torch.float64) + 9223372036854775808.0, min=1.0) / 2.0 ** 64
    return (k - 1) / frac


def _sketch_plain(op, a, av, b, bv, p):
    n = a.shape[0]
    dev = a.device
    m = (a.shape[1] - 1) // 2
    valid = av.clone() if av is not None else torch.ones(n, dtype=torch.bool, device=dev)
    if op == HLL_CARD:  # the warp's order: lane l adds registers l, l + 32, ... then a tree
        cnt = torch.clamp(a[:, 0], 0, m)
        present = _jj(m, dev) < cnt[:, None]
        w = torch.where(present, rho_weights(a[:, 1 + m:1 + 2 * m]), torch.zeros((), dtype=
                                                                              torch.float64))
        w = torch.cat([w, torch.zeros(n, -m % 32, dtype=torch.float64, device=dev)], 1)
        acc = torch.zeros(n, 32, dtype=torch.float64, device=dev)
        for i in range(w.shape[1] // 32):
            acc = acc + w[:, 32 * i:32 * i + 32]
        for off in (16, 8, 4, 2, 1):
            acc = acc[:, :off] + acc[:, off:2 * off]
        alpha = 0.7213 / (1.0 + 1.079 / m)
        zeros = (m - cnt).to(torch.float64)
        raw = alpha * m * m / torch.clamp(acc[:, 0] + zeros, min=1e-12)
        lc = m * torch.log(m / torch.clamp(zeros, min=1.0))
        est = torch.where((raw <= 2.5 * m) & (zeros > 0), lc, raw)
        return torch.round(est).to(torch.int64), valid
    if op == KMV_CARD:
        ln = torch.clamp(a[:, 0], min=0)
        est = torch.round(kmv_estimate(m, a[:, m])).to(torch.int64)
        return torch.where(ln < m, ln, torch.maximum(est, ln)), valid
    # SD_PAIR: the reference's sorted concatenation of the two hash lists
    big = torch.iinfo(torch.int64).max
    j = _jj(m, dev)
    la, lb = (torch.clamp(t[:, 0], 0, m)[:, None] for t in (a, b))
    ha = torch.where(j < la, a[:, 1:1 + m], torch.full_like(a[:, 1:1 + m], big))
    hb = torch.where(j < lb, b[:, 1:1 + m], torch.full_like(b[:, 1:1 + m], big))
    s = torch.sort(torch.cat([ha, hb], 1), 1)[0]
    live = s < big
    firsts = torch.ones_like(live)
    firsts[:, 1:] = s[:, 1:] != s[:, :-1]
    firsts &= live
    nxt_dup = torch.zeros_like(live)
    nxt_dup[:, :-1] = s[:, 1:] == s[:, :-1]
    rank = torch.cumsum(firsts.to(torch.int64), 1) - 1
    in_s = firsts & (rank < m)
    inter = (in_s & nxt_dup).sum(1)
    s_size = in_s.sum(1)
    jac = inter.to(torch.float64) / torch.clamp(s_size, min=1)
    ok = valid & bv
    if p[0] == SD_JACCARD:
        return jac, ok
    total = firsts.sum(1)
    kth = torch.where(in_s, s, torch.full_like(s, -big - 1)).max(1)[0]
    union = torch.where(total < m, total, torch.round(kmv_estimate(m, kth)).to(torch.int64))
    return torch.round(jac * union).to(torch.int64), ok


def ml_features(b: torch.Tensor, k: int) -> torch.Tensor:
    """The ``(n, k)`` features of a matrix as doubles, a NULL element 0.0
    (the reference's ``feats_matrix``)."""
    slots = b[:, 1:1 + k]
    return torch.where(is_null(slots), torch.zeros((), dtype=torch.float64, device=b.device),
                       slots.to(torch.float64))


def classify_ll_plain(a: torch.Tensor, b: torch.Tensor, k: int, C: int) -> torch.Tensor:
    """Each class's log-likelihood ``(n, C)`` under the naive Bayes model
    rows ``a`` for the features ``b`` (CLASSIFY's arithmetic)."""
    m = a[:, 1:]
    x = ml_features(b, k)
    n = x.shape[0]
    prior = m[:, 1:1 + C]
    mean = m[:, 1 + C:1 + C + C * k].reshape(n, C, k)
    var = torch.clamp(m[:, 1 + C + C * k:1 + C + 2 * C * k].reshape(n, C, k), min=1e-12)
    d = x[:, None, :] - mean
    terms = -0.5 * torch.log(6.283185307179586 * var) - d * d / (2.0 * var)
    s = torch.zeros((n, C), dtype=torch.float64, device=a.device)
    for j in range(k):
        s = s + terms[:, :, j]
    return torch.log(torch.clamp(prior, min=1e-12)) + s


def first_argmax(ll: torch.Tensor) -> torch.Tensor:
    """The first index of each row's greatest value, a NaN counting as
    the greatest (``jnp.argmax``)."""
    best = torch.zeros(ll.shape[0], dtype=torch.int64, device=ll.device)
    best_ll = ll[:, 0]
    for c in range(1, ll.shape[1]):
        take = ~torch.isnan(best_ll) & ((ll[:, c] > best_ll) | torch.isnan(ll[:, c]))
        best = torch.where(take, torch.full_like(best, c), best)
        best_ll = torch.where(take, ll[:, c], best_ll)
    return best


def _ml_plain(op, a, av, b, bv, p):
    n, dev = a.shape[0], a.device
    k = p[0]
    ok = (av if av is not None else torch.ones(n, dtype=torch.bool, device=dev)) & \
        (bv if bv is not None else torch.ones(n, dtype=torch.bool, device=dev))
    if op == REGRESS:
        w = a[:, 1:]
        x = ml_features(b, k)
        s = torch.zeros(n, dtype=torch.float64, device=dev)
        for j in range(k):
            s = s + w[:, j] * x[:, j]
        return s + w[:, k], ok
    ll = classify_ll_plain(a, b, k, p[1])
    best = first_argmax(ll)
    if p[2]:
        return best, ok, ll.gather(1, best[:, None])[:, 0]
    return best, ok


def _factor(mode: int, bits: int):
    """COERCE's factor from its parameter: an integer power of ten, or a
    double's bits for the double conversions."""
    if mode in (C_DEC2DBL, C_DBL2DEC):
        return struct.unpack("<d", struct.pack("<q", bits))[0]
    return bits


def double_bits(v: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(v)))[0]


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------

def _out_shapes(op, n, a, out_m, out_dtype, p, y):
    """(data dtype, shape) of the outputs a launch writes."""
    T = a.dtype if a is not None else out_dtype
    if op in (CARD, POSITION, HLL_CARD, KMV_CARD):
        return [(torch.int64, (n,)), (torch.bool, (n,))]
    if op == SD_PAIR:
        return [(torch.float64 if p[0] == SD_JACCARD else torch.int64, (n,)),
                (torch.bool, (n,))]
    if op == REGRESS:
        return [(torch.float64, (n,)), (torch.bool, (n,))]
    if op == CLASSIFY:  # p[2]: the winning log-likelihood too
        return [(torch.int64, (n,)), (torch.bool, (n,))] + \
            ([(torch.float64, (n,))] if p[2] else [])
    if op in (CONTAINS, OVERLAP, MATCH):
        return [(torch.bool, (n,)), (torch.bool, (n,))]
    if op == REDUCE:
        return [(torch.float64 if p[0] == R_AVG else T, (n,)), (torch.bool, (n,))]
    if op in (SUBSCRIPT, MAP_GET, ROW_FIELD):
        return [(T, (n,)), (torch.bool, (n,))]
    if op == SLOT:
        return [(T, (n,)), (torch.bool, (n,)), (torch.bool, (n,))]
    if op == REMOVE:
        return [(T, (n, a.shape[1])), (torch.bool, (n,))]
    if op == TABLE:
        return [(a.dtype, (n, a.shape[1])), (torch.bool, (n,))]
    if op in (SORT, DISTINCT, SLICE):
        return [(T, tuple(a.shape))]
    if op == COERCE:
        return [(out_dtype, tuple(a.shape))]
    if op == MAP_HALF:
        return [(out_dtype, (n, 1 + p[5]))]
    if op in (CONSTRUCT_MAP, COMPACT_PAIRS, TKEYS, MAP_CONCAT):
        return [(T, (n, 1 + 2 * out_m))]
    if op == CONSTRUCT:
        return [(y.dtype, (n, out_m + (1 if p[0] else 0)))]
    if op == ASSEMBLE:
        return [(y.dtype, (n, 1 + out_m * (2 if p[0] else 1)))]
    if op in (SEQUENCE, REPEAT):
        return [(out_dtype, (n, 1 + out_m))]
    return [(T, (n, 1 + out_m))]


def container_eval(op: int, a: Optional[torch.Tensor] = None, av=None, b=None, bv=None,
                   c=None, x=None, xv=None, y=None, yv=None, off=None, out_m: int = 0,
                   out_dtype: Optional[torch.dtype] = None, p: Sequence[int] = ()):
    """One K12 opcode over ``n`` rows.  ``a``, ``b``, ``c``: container
    matrices (``av``, ``bv``: their row validity); ``x``/``xv``: a
    scalar lane; ``y``/``yv``: a flattened body (with ``off``, the
    ``n + 1`` element offsets) or CONSTRUCT's stacked lanes; ``out_m``:
    the output's slot count; ``p``: the opcode's parameters (MAP_GET,
    COMPACT_PAIRS, TKEYS, MAP_HALF, MAP_CONCAT and COERCE read the map's
    entry count at ``p[5]``).  The outputs as :func:`plain` gives them."""
    p = [int(v) for v in p] + [0] * (6 - len(p))
    ref = next(t for t in (a, x, y, off) if t is not None)
    if not ref.is_cuda:
        return plain(op, a, av, b, bv, c, x, xv, y, yv, off, out_m, out_dtype, p)
    global launches
    n = x.shape[0] if op in (TABLE, SEQUENCE, REPEAT) else a.shape[0] if a is not None \
        else y.shape[0] if op == CONSTRUCT else off.shape[0] - 1
    if op == SEQUENCE and out_dtype != torch.int64:
        raise ValueError("container_eval: sequence is bigint")
    for t in (a, b, c):
        if t is not None and (t.dim() != 2 or t.dtype not in STORAGE or t.shape[0] != n
                              and op != TABLE):
            raise ValueError("container_eval: containers are (n, slots) int32, int64 or "
                             "float64 matrices")
    if not 0 <= op < len(OP_NAMES):
        raise ValueError(f"container_eval: opcode {op}")
    if (a is not None and a.shape[1] > (1 << 20)) or out_m > (1 << 20):
        raise ValueError("container_eval: more than 2^20 slots")
    T = y.dtype if op in (CONSTRUCT, ASSEMBLE) else torch.int64 if op == MATCH else \
        a.dtype if a is not None else out_dtype
    if T not in STORAGE or (out_dtype is not None and out_dtype not in STORAGE):
        raise ValueError("container_eval: storage must be int32, int64 or float64")
    if op == MATCH and av is None:
        raise ValueError("container_eval: match needs the containers' validity")
    tensors = [t for t in (a, av, b, bv, c, x, xv, y, yv, off) if t is not None]
    build.require_cuda(tensors, "container_eval")
    for t in (av, bv, xv, yv):
        if t is not None and t.dtype != torch.bool:
            raise ValueError("container_eval: validity must be bool")
    if x is not None and x.dtype not in _KIND:
        raise ValueError("container_eval: lanes are bool, int32, int64 or float64")
    if y is not None and y.dtype not in _KIND:
        raise ValueError("container_eval: body lanes are bool, int32, int64 or float64")
    if off is not None and (off.dtype != torch.int64 or off.shape != (n + 1,)):
        raise ValueError("container_eval: offsets are (n + 1,) int64")
    dev = ref.device
    outs = [torch.empty(shape, dtype=dt, device=dev)
            for dt, shape in _out_shapes(op, n, a, out_m, out_dtype, p, y)]
    outs += [None] * (3 - len(outs))

    def ptr(t):
        return t.data_ptr() if t is not None else 0

    def width(t):
        return t.shape[1] if t is not None and t.dim() == 2 else 0

    def kind(t):
        return _KIND[t.dtype] if t is not None else 0

    ptrs = [ptr(a), ptr(av), ptr(b), ptr(bv), ptr(c), ptr(x), ptr(xv), ptr(y), ptr(yv),
            ptr(off), ptr(outs[0]), ptr(outs[1]), ptr(outs[2])]
    ints = [_KIND[T], width(a), kind(b), width(b), kind(c), width(c), kind(x), kind(y),
            width(y), kind(outs[0]), width(outs[0]), out_m,
            a.shape[0] if a is not None else 0] + p
    lib = build.library()
    fn = lib.k12_container_eval
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    err = fn(op, n, build.ptrs(ptrs), build.ptrs(ints), build.stream_of(ref))
    build.check(err, f"container_eval {OP_NAMES[op]}")
    launches += 1
    op_launches[OP_NAMES[op]] = op_launches.get(OP_NAMES[op], 0) + 1
    got = [o for o in outs if o is not None]
    return got[0] if len(got) == 1 else tuple(got)
