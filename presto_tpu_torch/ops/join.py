"""Join build and probes over Pages.

Counterpart of ``presto_tpu/ops/join.py``.  Keys pack exactly from
their known domains, or hash (the reference's ``pack_or_hash_keys``,
K9) when a key has none.  The build is the reference's unique-direct
table when the planner promises distinct keys and the domain fits the
direct budget, else the sorted build with, on an accelerator as here,
the CSR ``starts`` table over the domain (never for hashed keys); both
run on K4 ``join_build``, which also sets the build's NULL-key and
nonempty flags for three-valued IN / NOT IN.  The row-aligned probe
(inner and left against a unique build; semi, anti and mark against
any) runs on K5 ``join_probe``, the expanding probe (inner, left and
FULL against repeated keys) on K8 ``join_expand``.  The executor's
``_is_streaming_join`` decides which probe a plan join takes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.expr.ir import Expr
from presto_tpu_torch.kernels import join_build as k4
from presto_tpu_torch.kernels import join_expand as k8
from presto_tpu_torch.kernels import join_probe as k5
from presto_tpu_torch.kernels.keys import Key
from presto_tpu_torch.page import Block, Page, _torch_dtype
from presto_tpu_torch.types import BOOLEAN, Type

# direct-address table caps, as the reference's
DIRECT_DOMAIN_MAX = 1 << 26
DIRECT_DOMAIN_PER_ROW = 64

_KEY_DTYPES = (torch.bool, torch.int32, torch.int64)
_HASHED_KEY_DTYPES = _KEY_DTYPES + (torch.float64,)


def _direct_budget(page: Page) -> int:
    """Largest key domain worth a direct-address table for this build
    size (shared by the sorted and unique paths so they agree)."""
    return min(DIRECT_DOMAIN_MAX, max(1 << 20, DIRECT_DOMAIN_PER_ROW * page.capacity))


def packed_domain_size(domains) -> Optional[int]:
    """Size of the packed-key code space [0, prod) when every key
    column has a known domain (per-column cardinality hi - lo + 2, code
    0 reserved for NULL)."""
    if not domains or any(d is None for d in domains):
        return None
    prod = 1
    for lo, hi in domains:
        prod *= int(hi - lo + 2)
    return prod if prod < (1 << 62) else None


@dataclasses.dataclass
class JoinBuild:
    """Build-side index (LookupSource analog)."""

    sorted_keys: torch.Tensor  # int64 (cap,): keys, I64_MAX past the live ones
    perm: torch.Tensor  # int32 (cap,): sorted position -> build row
    page: Page  # the build page (payload source)
    # int32 (2,) on the device: a live row has a NULL key; a row is live
    # (three-valued IN / NOT IN, read by the null-aware probes)
    flags: torch.Tensor
    # direct-address table: starts[k] = first sorted position with key
    # >= k, for k in [0, domain]; int32 (domain + 1,)
    starts: Optional[torch.Tensor] = None
    # unique-direct builds: False iff the uniqueness promise was broken
    # (the caller rebuilds down the sorted branch); device bool scalar
    unique_ok: Optional[torch.Tensor] = None


def key_columns(page: Page, key_exprs: Sequence[Expr], key_domains) -> List[Key]:
    """The key inputs of a page (see :func:`key_tuples`), evaluated by
    K1 where they are expressions or their dictionary repeats a value
    (codes of equal values become one code)."""
    c = ExprCompiler.for_page(page)
    return key_tuples([c.compile_key(e)(page) for e in key_exprs],
                      [e.type for e in key_exprs], key_domains)


def key_tuples(cols: Sequence[Tuple[torch.Tensor, torch.Tensor]], types: Sequence[Type],
               key_domains) -> List[Key]:
    """``(data, valid, lo, card)`` per key column: exact from the
    domains when every one is known and their product fits 62 bits,
    else hashed (card 0), as the reference's ``pack_or_hash_keys``
    decides."""
    exact = len(key_domains or ()) == len(cols) and \
        packed_domain_size(key_domains) is not None
    out = []
    for i, ((d, v), t) in enumerate(zip(cols, types)):
        check_key_type(t)
        if d.dtype not in (_KEY_DTYPES if exact else _HASHED_KEY_DTYPES):
            raise NotPorted(f"keys of type {t}")
        if exact:
            lo, hi = key_domains[i]
            out.append((d, v, int(lo), int(hi - lo + 2)))
        else:
            out.append((d, v, 0, 0))
    return out


def check_key_type(t: Type) -> None:
    """The reference's refusals for key columns (``pack_or_hash_keys``):
    long decimals have no hash; raw strings hash through ``hash_bytes``,
    which is not ported."""
    if t.is_raw_string or t.is_binary:
        raise NotPorted(f"keys over raw strings ({t})")
    if t.value_shape != ():
        raise ValueError("long-decimal grouping/join keys unsupported (cast to a "
                         "shorter decimal or double)")


def build_join(
    page: Page,
    key_exprs: Sequence[Expr],
    key_domains: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
    null_safe: bool = False,
    unique: bool = False,
) -> JoinBuild:
    """``null_safe``: NULL keys match each other (IS NOT DISTINCT FROM,
    the INTERSECT/EXCEPT comparison); default SQL joins drop them.
    ``unique``: the planner promises distinct build keys; with an exact
    domain inside the direct budget the build then skips the sort and
    reports a broken promise through ``unique_ok``.  Otherwise the
    sorted build also writes the CSR ``starts`` table when the domain
    fits the budget (the reference's choice on an accelerator); past
    it, or for hashed keys, probes binary-search the sorted keys."""
    keys = key_columns(page, key_exprs, key_domains)
    prod = packed_domain_size(key_domains)
    in_budget = prod is not None and prod <= _direct_budget(page)
    if unique and in_budget:
        sk, perm, starts, ok, flags = k4.join_build_unique(keys, page.row_mask, prod,
                                                           null_safe)
        return JoinBuild(sk, perm, page, flags, starts, unique_ok=ok)
    sk, perm, starts, flags = k4.join_build_sorted(keys, page.row_mask,
                                                   prod if in_budget else None, null_safe)
    return JoinBuild(sk, perm, page, flags, starts)


def _columns(page: Page):
    return [(b.data, b.valid) for b in page.blocks]


def probe_join(
    build: JoinBuild,
    probe: Page,
    probe_key_exprs: Sequence[Expr],
    key_domains: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
    kind: str = "inner",
    null_safe: bool = False,
    null_aware: bool = False,
) -> Page:
    """Probe-aligned join for unique (or first-match) build keys.

    kind: inner | left | semi | anti | mark.  inner and left emit the
    probe blocks followed by every build block; semi and anti the probe
    blocks with the row mask filtered; mark the probe blocks and a
    BOOLEAN match column.  ``null_aware`` (semi, anti, mark) selects
    ANSI three-valued IN / NOT IN: an unmatched probe whose key is NULL
    against a nonempty build, or any unmatched probe when the build
    holds a NULL key, is UNKNOWN, which filters as FALSE and shows as a
    NULL mark; an empty build is FALSE for every probe."""
    code = k5.KINDS[kind]
    gathers = code in (k5.INNER, k5.LEFT)
    if null_aware and gathers:
        raise ValueError(f"null_aware applies to semi, anti and mark joins, not {kind}")
    keys = key_columns(probe, probe_key_exprs, key_domains)
    outs, mask = k5.join_probe(
        keys, probe.row_mask, build.sorted_keys, build.perm, build.starts,
        _columns(build.page) if gathers else [], code, null_safe, null_aware, build.flags)
    out_blocks = list(probe.blocks)
    if gathers:
        for b, (data, valid) in zip(build.page.blocks, outs):
            out_blocks.append(Block(data, valid, b.type, b.dictionary))
    elif code == k5.MARK:
        out_blocks.append(Block(outs[0][0], outs[0][1], BOOLEAN))
    return Page(tuple(out_blocks), mask)


def probe_expand(
    build: JoinBuild,
    probe: Page,
    probe_key_exprs: Sequence[Expr],
    key_domains: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
    kind: str = "inner",
    return_matched: bool = False,
    null_safe: bool = False,
):
    """Many-to-many join: each probe row emits one output row per
    matching build row, probe row first, then the build's sorted
    position; ``left`` emits one NULL-extended row for a probe with no
    match.  Returns ``(page, total)``, the page sized from the match
    count (no capacity retry); with ``return_matched`` also a bool
    (build capacity,) mask of the build rows a match touched, which the
    caller ORs across probe pages for the FULL OUTER tail."""
    if kind not in ("inner", "left"):
        raise ValueError(kind)
    keys = key_columns(probe, probe_key_exprs, key_domains)
    matched = None
    if return_matched:
        matched = torch.zeros(build.page.capacity, dtype=torch.bool, device=probe.device)
    p_out, b_out, total = k8.join_expand(
        keys, probe.row_mask, build.sorted_keys, build.perm, build.starts,
        _columns(probe), _columns(build.page), kind == "left", null_safe, matched)
    blocks = [Block(d, v, b.type, b.dictionary) for (d, v), b in zip(p_out, probe.blocks)]
    blocks += [Block(d, v, b.type, b.dictionary)
               for (d, v), b in zip(b_out, build.page.blocks)]
    rows = max(total, 1)
    mask = torch.arange(rows, device=probe.device) < total
    page = Page(tuple(blocks), mask)
    return (page, total, matched) if return_matched else (page, total)


def outer_build_tail(build: JoinBuild, matched: torch.Tensor,
                     probe_types_dicts: Sequence[Tuple]) -> Page:
    """FULL OUTER tail: build rows never matched by any probe page,
    NULL-extended on the probe columns (``probe_types_dicts``:
    ``[(Type, Dictionary or None)]`` of the probe side's output)."""
    cap = build.page.capacity
    dev = build.page.device
    blocks: List[Block] = [
        Block(torch.zeros((cap,) + tuple(t.value_shape), dtype=_torch_dtype(t), device=dev),
              torch.zeros(cap, dtype=torch.bool, device=dev), t, d)
        for t, d in probe_types_dicts]
    blocks += list(build.page.blocks)
    return Page(tuple(blocks), build.page.row_mask & ~matched)
