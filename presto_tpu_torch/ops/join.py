"""Join build and probe over Pages.

Counterpart of ``presto_tpu/ops/join.py``.  Keys pack exactly from
their known domains (the reference's ``pack_or_hash_keys`` exact
branch); the build is the reference's unique-direct table when the
planner promises distinct keys and the domain fits the direct budget,
else the sorted build with, on an accelerator as here, the CSR
``starts`` table over the domain.  Both run on K4 ``join_build``; the
row-aligned inner probe runs on K5 ``join_probe``.  Other join kinds,
hashed keys and the expanding (many-to-many) probe raise
:class:`NotPorted`; the executor's ``_check_streaming_join`` decides
which plan joins reach these functions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.expr.ir import Expr
from presto_tpu_torch.kernels import join_build as k4
from presto_tpu_torch.kernels import join_probe as k5
from presto_tpu_torch.kernels.keys import Key
from presto_tpu_torch.page import Block, Page

# direct-address table caps, as the reference's
DIRECT_DOMAIN_MAX = 1 << 26
DIRECT_DOMAIN_PER_ROW = 64


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

    sorted_keys: torch.Tensor  # int64 (cap,): packed keys, I64_MAX past the live ones
    perm: torch.Tensor  # int32 (cap,): sorted position -> build row
    page: Page  # the build page (payload source)
    # direct-address table: starts[k] = first sorted position with key
    # >= k, for k in [0, domain]; int32 (domain + 1,)
    starts: Optional[torch.Tensor] = None
    # unique-direct builds: False iff the uniqueness promise was broken
    # (the caller rebuilds down the sorted branch); device bool scalar
    unique_ok: Optional[torch.Tensor] = None


def key_columns(page: Page, key_exprs: Sequence[Expr], key_domains) -> List[Key]:
    """The exact packed-key inputs of a page: ``(data, valid, lo, card)``
    per key expression, evaluated by K1 where they are expressions."""
    from presto_tpu_torch.ops.aggregate import _collation_lists, expr_key_dicts

    if packed_domain_size(key_domains) is None:
        raise NotPorted("join keys without exact packed domains (hashed keys)")
    if any(d is not None and _collation_lists(d)[3]
           for d in expr_key_dicts(page, key_exprs)):
        raise NotPorted("join keys over a dictionary with duplicate values")
    c = ExprCompiler.for_page(page)
    out = []
    for e, (lo, hi) in zip(key_exprs, key_domains):
        if e.type.value_shape != () or e.type.is_raw_string:
            raise NotPorted(f"join keys of type {e.type}")
        d, v = c.compile(e)(page)
        out.append((d, v, int(lo), int(hi - lo + 2)))
    return out


def build_join(
    page: Page,
    key_exprs: Sequence[Expr],
    key_domains: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
    unique: bool = False,
) -> JoinBuild:
    """``unique``: the planner promises distinct build keys; with a
    domain inside the direct budget the build then skips the sort and
    reports a broken promise through ``unique_ok``.  Otherwise the
    sorted build also writes the CSR ``starts`` table when the domain
    fits the budget (the reference's choice on an accelerator); past
    it, probes binary-search the sorted keys."""
    keys = key_columns(page, key_exprs, key_domains)
    prod = packed_domain_size(key_domains)
    in_budget = prod <= _direct_budget(page)
    if unique and in_budget:
        sk, perm, starts, ok = k4.join_build_unique(keys, page.row_mask, prod)
        return JoinBuild(sk, perm, page, starts, unique_ok=ok)
    sk, perm, starts = k4.join_build_sorted(keys, page.row_mask, prod if in_budget else None)
    return JoinBuild(sk, perm, page, starts)


def probe_join(
    build: JoinBuild,
    probe: Page,
    probe_key_exprs: Sequence[Expr],
    key_domains: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
    kind: str = "inner",
) -> Page:
    """Probe-aligned inner join for unique (or first-match) build keys:
    the probe blocks followed by every build block, the row mask
    narrowed to matched rows."""
    if kind != "inner":
        raise NotPorted(f"{kind} join probe")
    keys = key_columns(probe, probe_key_exprs, key_domains)
    blocks = build.page.blocks
    outs, match = k5.join_probe(keys, probe.row_mask, build.sorted_keys, build.perm,
                                build.starts, [(b.data, b.valid) for b in blocks])
    out_blocks = list(probe.blocks)
    for b, (data, valid) in zip(blocks, outs):
        out_blocks.append(Block(data, valid, b.type, b.dictionary))
    return Page(tuple(out_blocks), match)


def probe_expand(*args, **kwargs):
    """Many-to-many probe with capacity retry: not ported."""
    raise NotPorted("expanding (many-to-many) join probe")
