"""Single-process pipeline executor.

Counterpart of ``presto_tpu/exec/local.py``.  Every streaming chain of
a plan (scan -> filter -> project -> join probe -> partial aggregation)
runs as one function per split, as the reference fuses it; here each
stage is a kernel launch on the runner's device (K1 for filters,
projections and aggregate arguments, K5 for a row-aligned join probe,
K2 or K6 for the partial states).  Pipeline breakers materialize: a
join's build side is built once (K4; a broken uniqueness promise
rebuilds it down the sorted branch), a many-to-many join expands each
probe page (K8) and, for FULL OUTER, emits the unmatched build rows
last, the aggregation folds per-split packed partial tables slot by
slot (K3) or merges the sort-path partials once (K6) and finalizes
(K3), a window node sorts its input as one page and evaluates its
functions (K10), the sort orders the result and top-N picks its rows
(K7).

Ported: table scans, filters, projections, every join kind (inner,
left, full, semi, anti, mark; null-safe and null-aware keys) except
index joins, the cross join with a one-row relation (a scalar
subquery, broadcast on the device), window functions (one page, K10),
ORDER BY, top-N, LIMIT (a running count of live rows), VALUES, a
precomputed page, UNION ALL (each leg's pages with their dictionary
codes moved into the union's merged dictionaries), GroupId (each page
once per grouping set, streamed), and global, packed-direct, sort-path
or streaming (presorted) aggregation over exact or hashed keys.  Other
plan nodes raise :class:`NotPorted`.  PyTorch runs eagerly, so there are no
compiled-program caches and no capacity buckets: the sort path and the
expanding probe size their outputs from the count they find, so
nothing is dropped and no capacity retry is needed.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from presto_tpu_torch import NotPorted, resolve_device
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.ops.aggregate import (
    combine_packed_states, finalize_packed, grouped_aggregate, merge_aggregate, takes_sort_path,
)
from presto_tpu_torch.ops.filter_project import filter_page, project_page
from presto_tpu_torch.ops.join import (
    JoinBuild, build_join, outer_build_tail, probe_expand, probe_join,
)
from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.ops.sort import limit_page, sort_page, topn_page
from presto_tpu_torch.ops.window import window_page
from presto_tpu_torch.page import (
    Block, Page, concat_pages_device, cross_append_single, pad_page_to, remap_union_leg_page,
)
from presto_tpu_torch.planner.plan import (
    AggregationNode,
    CrossSingleNode,
    FilterNode,
    GroupIdNode,
    JoinNode,
    LimitNode,
    OutputNode,
    PlanNode,
    PrecomputedNode,
    ProjectNode,
    SortNode,
    TableScanNode,
    TopNNode,
    UnionNode,
    ValuesNode,
    WindowNode,
)
from presto_tpu_torch.types import Type


@dataclasses.dataclass
class MaterializedResult:
    """Host-side query result."""

    names: List[str]
    types: List[Type]
    rows: List[tuple]

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)


def _values_columns(node: ValuesNode):
    """(columns, types, valids) of a VALUES node's literal rows."""
    import numpy as np

    cols, valids = [], []
    for i, t in enumerate(node.types):
        raw = [r[i] for r in node.rows]
        valids.append(np.asarray([v is not None for v in raw], np.bool_))
        if t.is_long_decimal:
            cols.append(raw)  # limbs: unscaled values may pass int64
        else:
            cols.append(np.asarray([0 if v is None else v for v in raw], dtype=t.np_dtype))
    return cols, node.types, valids


class QueryStats:
    """Per-plan-node execution stats: pages, live rows and wall seconds
    (inclusive of upstream stages, which run fused per split).  Counting
    rows synchronises with the device once per page."""

    def __init__(self):
        self.by_node: Dict[int, Dict[str, float]] = {}
        self._pin: List[PlanNode] = []  # keeps id() of recorded nodes unique
        self._lock = threading.Lock()

    def record(self, node: PlanNode, wall: float, rows: int) -> None:
        with self._lock:
            e = self.by_node.get(id(node))
            if e is None:
                e = self.by_node[id(node)] = {"pages": 0, "rows": 0, "wall_s": 0.0}
                self._pin.append(node)
            e["pages"] += 1
            e["rows"] += rows
            e["wall_s"] += wall

    def actual_rows(self, node: PlanNode) -> Optional[int]:
        e = self.by_node.get(id(node))
        return None if e is None else int(e["rows"])


def _is_streaming_join(node: JoinNode) -> bool:
    """True when the probe is row-aligned (K5, fused in a chain):
    semi/anti/mark (presence tests) or unique-key builds.  FULL joins
    always expand: the unmatched-build tail needs cross-page state.
    Index joins (not ported) never fuse."""
    if node.kind == "full" or node.use_index:
        return False
    return node.kind in ("semi", "anti", "mark") or node.unique_build


class LocalRunner:
    """Executes a plan tree against registered connectors on ``device``
    (default ``cuda``; see :func:`presto_tpu_torch.resolve_device`)."""

    def __init__(self, catalog: Catalog, device=None):
        self.catalog = catalog
        self.device = resolve_device(device)
        self.stats: Optional[QueryStats] = None
        self._partial_nodes: Dict[PlanNode, AggregationNode] = {}
        # join builds of the running query, by join node
        self._builds: Dict[PlanNode, JoinBuild] = {}

    # ------------------------------------------------------------------
    def run(self, plan: PlanNode) -> MaterializedResult:
        rows = self.run_to_page(plan).compact_host().to_pylist()
        return MaterializedResult(names=plan.output_names, types=plan.output_types,
                                  rows=rows)

    def run_to_page(self, plan: PlanNode) -> Page:
        try:
            pages = list(self._pages(plan))
        finally:
            self._builds.clear()  # a build lives for one query
        if not pages:
            return Page.empty(plan.output_types, 1, self.device)
        return concat_pages_device(pages)

    def _pages(self, node: PlanNode) -> Iterator[Page]:
        if self.stats is None:
            yield from self._pages_impl(node)
            return
        gen = self._pages_impl(node)
        while True:
            t0 = time.perf_counter()
            try:
                p = next(gen)
            except StopIteration:
                return
            rows = int(p.num_rows())
            self.stats.record(node, time.perf_counter() - t0, rows)
            yield p

    def _pages_impl(self, node: PlanNode) -> Iterator[Page]:
        if isinstance(node, OutputNode):
            yield from self._pages(node.source)
            return
        if isinstance(node, SortNode):
            pages = list(self._pages(node.source))
            src = concat_pages_device(pages) if pages else Page.empty(
                node.output_types, 1, self.device)
            yield sort_page(src, list(node.sort_exprs), list(node.ascending),
                            node.nulls_first)
            return
        if isinstance(node, TopNNode):
            yield self._run_topn(node)
            return
        if isinstance(node, LimitNode):
            remaining = node.count
            for p in self._pages(node.source):
                if remaining <= 0:
                    return
                p = limit_page(p, remaining)
                remaining -= int(p.num_rows())
                yield p
            return
        if isinstance(node, ValuesNode):
            yield Page.from_arrays(*_values_columns(node), dictionaries=node.dictionaries,
                                   device=self.device)
            return
        if isinstance(node, PrecomputedNode):
            yield node.page.to(self.device)
            return
        if isinstance(node, UnionNode):
            # each leg's pages, its dictionary codes moved into the
            # union's merged dictionaries and its blocks retyped
            for src, offs in zip(node.inputs, node.code_offsets):
                for p in self._pages(src):
                    yield remap_union_leg_page(p, offs, node.channels)
            return
        if isinstance(node, GroupIdNode):
            yield from self._groupid_pages(node)
            return
        if isinstance(node, AggregationNode) and node.step in ("single", "final"):
            yield self._run_aggregation(node)
            return
        if isinstance(node, WindowNode):
            # breaker: the source as one page, then the window functions
            # over it (sort, then K10)
            pages = list(self._pages(node.source))
            src = concat_pages_device(pages) if pages else Page.empty(
                node.source.output_types, 1, self.device)
            yield window_page(src, list(node.partition_exprs), list(node.order_exprs),
                              list(node.ascending), list(node.funcs),
                              partition_domains=node.partition_domains)
            return
        if isinstance(node, JoinNode) and node.use_index:
            raise NotPorted("index join")
        if isinstance(node, JoinNode) and not _is_streaming_join(node):
            yield from self._expanding_join_pages(node)
            return
        if isinstance(node, (TableScanNode, FilterNode, ProjectNode, AggregationNode,
                             JoinNode, CrossSingleNode)):
            yield from self._chain_pages(node)
            return
        raise NotPorted(f"plan node {type(node).__name__}")

    # ------------------------------------------------------------------
    # streaming chains
    # ------------------------------------------------------------------
    def _chain_pages(self, node: PlanNode) -> Iterator[Page]:
        stage = self._build_stage(node)
        for page in self._source_pages(self._chain_leaf(node)):
            yield stage(page)

    def _chain_leaf(self, node: PlanNode) -> PlanNode:
        if isinstance(node, (FilterNode, ProjectNode)):
            return self._chain_leaf(node.source)
        if isinstance(node, AggregationNode) and node.step == "partial":
            return self._chain_leaf(node.source)
        if isinstance(node, JoinNode) and _is_streaming_join(node):
            return self._chain_leaf(node.left)  # the probe side streams
        if isinstance(node, CrossSingleNode):
            return self._chain_leaf(node.left)
        return node

    def _build_stage(self, node: PlanNode):
        """fn(page) -> page for the streaming prefix of ``node``; the
        identity below the chain leaf."""
        if isinstance(node, FilterNode):
            inner = self._build_stage(node.source)
            pred = node.predicate
            return lambda p: filter_page(inner(p), pred)
        if isinstance(node, ProjectNode):
            inner = self._build_stage(node.source)
            projections = list(node.projections)
            return lambda p: project_page(inner(p), projections)
        if isinstance(node, AggregationNode) and node.step == "partial":
            inner = self._build_stage(node.source)
            group_exprs = list(node.group_exprs)
            aggs = list(node.aggs)
            mg = self._max_groups(node)
            kd = node.key_domains
            presorted = node.presorted
            return lambda p: grouped_aggregate(inner(p), group_exprs, aggs, mg,
                                               key_domains=kd, mode="partial",
                                               presorted=presorted)
        if isinstance(node, JoinNode) and _is_streaming_join(node):
            inner = self._build_stage(node.left)
            build = self._materialize_build(node)
            left_keys = list(node.left_keys)
            kd = node.key_domains
            kind, ns = node.kind, node.null_safe_keys
            # null_aware means IN / NOT IN; on a join that gathers build
            # columns it means nothing, and the reference's executor
            # drops it there, as here (probe_join refuses it)
            na = node.null_aware and kind in ("semi", "anti", "mark")
            return lambda p: probe_join(build, inner(p), left_keys, key_domains=kd, kind=kind,
                                        null_safe=ns, null_aware=na)
        if isinstance(node, CrossSingleNode):
            inner = self._build_stage(node.left)
            single = self._single_row(node)
            return lambda p: cross_append_single(inner(p), single)
        return lambda p: p

    def _source_pages(self, node: PlanNode) -> Iterator[Page]:
        if not isinstance(node, TableScanNode):
            yield from self._pages(node)
            return
        if node.sample is not None or node.limit is not None:
            raise NotPorted("TABLESAMPLE and pushed-down LIMIT scans")
        conn = self.catalog.connector(node.handle.connector_name)
        idx = list(node.columns)
        if node.splits is not None:
            splits = node.splits
        else:
            splits = range(conn.num_splits(node.handle.table)
                           if hasattr(conn, "num_splits") else node.handle.num_splits)
        td = None
        if node.constraints and hasattr(conn, "split_stats"):
            from presto_tpu_torch.predicate import TupleDomain

            td = TupleDomain.from_constraints(node.constraints)
            if td.is_none:
                return  # provably empty scan
        for split in splits:
            if td is not None and not td.overlaps_split_stats(
                    conn.split_stats(node.handle.table, split)):
                continue  # split statistics prove no row matches
            page = conn.page_for_split(node.handle.table, split)
            yield Page(tuple(page.blocks[i] for i in idx), page.row_mask).to(self.device)

    def _groupid_pages(self, node: GroupIdNode) -> Iterator[Page]:
        """Each source page once per grouping set, streamed: the source
        blocks, the key columns (K1 where they are expressions) with
        the set's inactive keys NULL, and a constant ``$group_id``."""
        key_exprs = list(node.key_exprs)
        nsrc = len(node.source.channels)
        key_chans = node.channels[nsrc:nsrc + len(key_exprs)]
        gid_type = node.channels[-1].type
        for p in self._pages(node.source):
            comp = ExprCompiler.for_page(p)
            keys = [comp.compile(e)(p) for e in key_exprs]
            ones = torch.ones(p.capacity, dtype=torch.bool, device=p.device)
            for gid, mask in enumerate(node.set_masks):
                blocks = list(p.blocks)
                for (d, v), live, e, ch in zip(keys, mask, key_exprs, key_chans):
                    blocks.append(Block(d, v if live else torch.zeros_like(v), e.type,
                                        ch.dictionary))
                blocks.append(Block(torch.full((p.capacity,), gid, dtype=torch.int64,
                                               device=p.device), ones, gid_type))
                yield Page(tuple(blocks), p.row_mask)

    # ------------------------------------------------------------------
    # joins and top-N
    # ------------------------------------------------------------------
    def _materialize_build(self, node: JoinNode) -> JoinBuild:
        """The build of ``node``, once per query: its build side padded
        as the reference pads it (its direct budget reads the
        capacity), built unique-direct when the planner promises unique
        keys, and rebuilt down the sorted branch when that promise
        fails."""
        build = self._builds.get(node)
        if build is None:
            page = self.build_side(node)
            right_keys = list(node.right_keys)
            kd = node.key_domains
            ns = node.null_safe_keys
            build = build_join(page, right_keys, key_domains=kd, null_safe=ns,
                               unique=node.unique_build)
            if build.unique_ok is not None and not bool(build.unique_ok):
                # the uniqueness promise failed at runtime: rebuild sorted
                build = build_join(page, right_keys, key_domains=kd, null_safe=ns,
                                   unique=False)
            self._builds[node] = build
        return build

    def _single_row(self, node: CrossSingleNode) -> Page:
        """The one-row side of ``node``, once per query, on the device."""
        page = self._builds.get(node)
        if page is None:
            pages = list(self._pages(node.right))
            page = self._builds[node] = concat_pages_device(pages) if pages else Page.empty(
                node.right.output_types, 1, self.device)
        return page

    def build_side(self, node: JoinNode) -> Page:
        """The build side's pages, concatenated and padded to a
        power-of-two capacity."""
        pages = list(self._pages(node.right))
        page = concat_pages_device(pages) if pages else Page.empty(
            node.right.output_types, 1, self.device)
        return pad_page_to(page, 1 << max(0, page.capacity - 1).bit_length())

    def _expanding_join_pages(self, node: JoinNode) -> Iterator[Page]:
        """Many-to-many probe of every probe page (K8), each output page
        sized from its match count; a FULL join ORs the build rows its
        matches touched across pages and ends with the unmatched build
        rows, NULL-extended on the probe side."""
        build = self._materialize_build(node)
        is_full = node.kind == "full"
        kind = "left" if is_full else node.kind
        left_keys = list(node.left_keys)
        kd = node.key_domains
        matched = None
        for p in self._pages(node.left):
            res = probe_expand(build, p, left_keys, key_domains=kd, kind=kind,
                               return_matched=is_full, null_safe=node.null_safe_keys)
            yield res[0]
            if is_full:
                matched = res[2] if matched is None else matched | res[2]
        if is_full:
            if matched is None:
                matched = torch.zeros(build.page.capacity, dtype=torch.bool,
                                      device=self.device)
            yield outer_build_tail(build, matched,
                                   [(c.type, c.dictionary) for c in node.left.channels])

    def _run_topn(self, node: TopNNode) -> Page:
        """Fold: keep the ``count`` best rows; each input page is ranked
        together with the accumulator (K7) and cut to ``count`` rows."""
        n = node.count
        acc: Optional[Page] = None
        for p in self._pages(node.source):
            cand = p if acc is None else concat_pages_device([acc, p])
            acc = topn_page(cand, list(node.sort_exprs), list(node.ascending), n,
                            node.nulls_first)
        if acc is None:
            return Page.empty(node.output_types, max(n, 1), self.device)
        return acc

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    def _max_groups(self, node: AggregationNode) -> int:
        kd = node.key_domains
        if node.group_exprs and kd and all(d is not None for d in kd):
            prod = 1
            for lo, hi in kd:
                prod *= hi - lo + 2
            if prod <= node.max_groups:
                return prod
        return node.max_groups

    def partial_node(self, node: AggregationNode) -> AggregationNode:
        """The per-split partial step this runner injects under a
        single-step aggregation."""
        partial = self._partial_nodes.get(node)
        if partial is None:
            partial = AggregationNode(
                source=node.source, group_exprs=node.group_exprs,
                group_names=node.group_names, aggs=node.aggs,
                agg_names=node.agg_names, step="partial",
                max_groups=node.max_groups, presorted=node.presorted)
            self._partial_nodes[node] = partial
        return partial

    def _run_aggregation(self, node: AggregationNode) -> Page:
        """Breaker: fold per-split packed partial tables slot by slot
        (one group for a global aggregation), or merge the sort path's
        per-split partials once; then finalize."""
        if node.step == "final":
            raise NotPorted("final aggregation over exchanged partial states")
        mg = self._max_groups(node)
        num_keys = len(node.group_exprs)
        aggs = list(node.aggs)
        # presorted partials stream (K6's presorted mode, in page order),
        # so a group cut by a split boundary comes out of two splits and
        # meets itself in the merge, as the sort path's partials do
        sort_path = takes_sort_path(node.group_exprs, node.key_domains, mg, aggs,
                                    node.presorted)
        partial = self.partial_node(node)
        if sort_path:
            parts = list(self._pages(partial))
            if not parts:
                return Page.empty(node.output_types, 1, self.device)
            return merge_aggregate(concat_pages_device(parts), num_keys, aggs, mg,
                                   key_domains=node.key_domains, mode="single")
        acc: Optional[Page] = None
        for p in self._pages(partial):
            acc = p if acc is None else combine_packed_states(acc, p, num_keys, aggs)
        if acc is None:
            if node.group_exprs:
                return Page.empty(node.output_types, max(mg, 1), self.device)
            # a global aggregation over no input still emits its row
            # (count 0, other aggregates NULL)
            empty = Page.empty(node.source.output_types, 1, self.device)
            return grouped_aggregate(empty, [], aggs, 1, mode="single")
        return finalize_packed(acc, num_keys, aggs)
