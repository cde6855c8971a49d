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
ORDER BY, top-N, LIMIT (a running count of live rows; pushed into a
scan, it stops reading splits once enough live rows came), TABLESAMPLE
SYSTEM (whole splits by a split hash) and BERNOULLI (a per-row hash
mask on the device), VALUES, a
precomputed page, UNION ALL (each leg's pages with their dictionary
codes moved into the union's merged dictionaries), GroupId (each page
once per grouping set, streamed; a keyless set's grand-total row where
no group came, the reference's ``_groupid_empty_fixup``), UNNEST (K13
per page), and global, packed-direct, sort-path or streaming
(presorted) aggregation over exact or hashed keys.  Other
plan nodes raise :class:`NotPorted`.  PyTorch runs eagerly, so there are no
compiled-program caches and no capacity buckets: the sort path and the
expanding probe size their outputs from the count they find, so
nothing is dropped and no capacity retry is needed.

Memory: every query runs under the runner's pool (``memory.py``),
which charges join builds, aggregation accumulators, sort inputs and,
softly, scan pages, with the reference's tags, and frees them at query
end.  A join build past the pool falls back to the partitioned join
(both sides split into host buckets by K11, each partition joined on
its own); a streaming join whose build trips it is demoted out of its
chain into that path; an aggregation accumulator past it re-runs
partitioned (the source rows split by K11, each bucket aggregated
alone).  The pool is the only spill trigger: the reference's capacity
trigger (``GroupCapacityExceeded`` past ``SPILL_GROUP_THRESHOLD``) has
no counterpart, since the port sizes its outputs from a count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional

import torch

from presto_tpu_torch import NotPorted, resolve_device
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.exec.spill import HostPage, SpillCounter, make_bucket_fn, partition_to_host
from presto_tpu_torch.expr.ir import ColumnRef
from presto_tpu_torch.memory import ExceededMemoryLimitError, QueryMemoryContext, page_bytes
from presto_tpu_torch.ops.aggregate import (
    combine_packed_states, finalize_packed, grouped_aggregate, merge_aggregate, takes_sort_path,
)
from presto_tpu_torch.ops.container import unnest_page
from presto_tpu_torch.ops.filter_project import filter_page, project_page
from presto_tpu_torch.ops.join import (
    JoinBuild, build_join, build_null_flags, outer_build_tail, probe_expand, probe_join,
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
    UnnestNode,
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


def _expr_columns(exprs) -> set:
    """The input columns ``exprs`` read (lambda bodies included)."""
    from presto_tpu_torch.expr.containers import _column_refs

    out: set = set()
    for e in exprs:
        if e is not None:
            out.update(_column_refs(e))
    return out


def _leaf_columns_read(node: PlanNode, leaf: PlanNode) -> Optional[set]:
    """The output columns of a chain's ``leaf`` that the chain from
    ``node`` down to it reads (None: every column, as when the leaf
    itself is the chain's top): an UNNEST replicates only those, so an
    aggregated array column that the query no longer reads is not
    copied once per element."""
    needed: Optional[set] = None
    cur = node
    while cur is not leaf:
        if isinstance(cur, ProjectNode):
            needed = _expr_columns(cur.projections)
        elif isinstance(cur, FilterNode):
            needed = None if needed is None else needed | _expr_columns([cur.predicate])
        elif isinstance(cur, AggregationNode):
            needed = _expr_columns(list(cur.group_exprs) + [x for a in cur.aggs for x in (
                a.arg, a.arg2, a.arg3, a.filter)])
        elif isinstance(cur, (JoinNode, CrossSingleNode)):
            width = len(cur.left.channels)
            keys = _expr_columns(cur.left_keys) if isinstance(cur, JoinNode) else set()
            needed = None if needed is None else {i for i in needed if i < width} | keys
        else:
            return None
        cur = cur.sources[0]
    return needed


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


def system_sample_drops(split: int, percent: float) -> bool:
    """TABLESAMPLE SYSTEM(p): whether a whole split is left out, by the
    reference's deterministic split hash (mixed so split 0 is not a
    fixed point)."""
    h = (((split + 1) * 2654435761) ^ 0x9E3779B9) % 10_000
    return h >= percent * 100


_U32 = 0xFFFFFFFF


def bernoulli_keep(capacity: int, split: int, percent: float, device) -> torch.Tensor:
    """TABLESAMPLE BERNOULLI(p): the reference's per-(split, row) hash
    mask, each row kept with probability p%, computed on the device.
    Its uint32 arithmetic runs in int64, masked to 32 bits after each
    step (a product of two 32-bit values wraps past 2^63, but its low
    32 bits are right)."""
    r = torch.arange(capacity, dtype=torch.int64, device=device)
    h = (r + ((split * 0x9E3779B1) & _U32)) & _U32
    h = ((h ^ (h >> 15)) * 0x85EBCA6B) & _U32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _U32
    return torch.remainder(h, 10_000) < int(percent * 100)


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
    (default ``cuda``; see :func:`presto_tpu_torch.resolve_device`),
    charging its device intermediates against ``memory_pool`` (None: no
    accounting) and spilling through ``spill_partitions`` host buckets
    where they exceed it."""

    def __init__(self, catalog: Catalog, device=None, memory_pool=None,
                 spill_partitions: int = 8):
        self.catalog = catalog
        self.device = resolve_device(device)
        self.memory_pool = memory_pool
        self.spill_partitions = spill_partitions
        self.stats: Optional[QueryStats] = None
        self._partial_nodes: Dict[PlanNode, AggregationNode] = {}
        # an UNNEST leaf's output columns its chain reads (None: all)
        self._unnest_needed: Dict[PlanNode, Optional[set]] = {}
        # join builds of the running query, by join node
        self._builds: Dict[PlanNode, JoinBuild] = {}
        # streaming joins demoted to the partitioned path (their build
        # tripped the pool); kept with the plan, as the reference keeps them
        self._force_expanding: set = set()
        self._mem: Optional[QueryMemoryContext] = None
        self._spilled = SpillCounter()
        #: the last query's peak reserved bytes, per-site peaks and spill
        self.last_peak_bytes = 0
        self.last_site_peaks: Dict[str, int] = {}
        self.last_spill = SpillCounter()

    # ------------------------------------------------------------------
    def run(self, plan: PlanNode) -> MaterializedResult:
        rows = self.run_to_page(plan).compact_host().to_pylist()
        return MaterializedResult(names=plan.output_names, types=plan.output_types,
                                  rows=rows)

    @contextlib.contextmanager
    def _query_mem(self):
        """One query's memory context over the pool: every reservation
        is tagged ``"{query id}/{site}#{seq}"`` and released at the end."""
        self._spilled = SpillCounter()
        if self.memory_pool is not None:
            self._mem = QueryMemoryContext(self.memory_pool, uuid.uuid4().hex[:8])
        try:
            yield
        finally:
            self.last_spill = self._spilled
            if self._mem is not None:
                self.last_peak_bytes = self._mem.peak
                self.last_site_peaks = dict(self._mem.site_peak)
                self._mem.release_all()
                self._mem = None

    def run_to_page(self, plan: PlanNode) -> Page:
        with self._query_mem():
            try:
                pages = list(self._pages(plan))
            finally:
                self._builds.clear()  # a build lives for one query
            if not pages:
                return Page.empty(plan.output_types, 1, self.device)
            return concat_pages_device(pages)

    def _account(self, what: str, page: Page, node: Optional[PlanNode] = None) -> Optional[str]:
        """Charge a materialized device intermediate against the pool
        (held to query end unless its tag is freed); ``node`` tags it
        (``what@id``) so a spill fallback can tell its own node's
        failure from another's."""
        if self._mem is None:
            return None
        if node is not None:
            what = f"{what}@{id(node)}"
        return self._mem.reserve(what, page_bytes(page))

    def _streaming(self, node: JoinNode) -> bool:
        return _is_streaming_join(node) and node not in self._force_expanding

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
            self._account("sort_input", src)
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
        if isinstance(node, UnnestNode):
            # each source page expanded to one row per element (K13);
            # a lateral WHERE is the FilterNode above
            chans = node.channels
            needed = self._unnest_needed.pop(node, None)
            for p in self._pages(node.source):
                yield unnest_page(p, list(node.unnest_exprs), node.ordinality, chans, needed)
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
        if isinstance(node, JoinNode) and not self._streaming(node):
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
        try:
            stage = self._build_stage(node)
        except ExceededMemoryLimitError as e:
            victim = next((j for j in self._chain_joins(node)
                           if f"join_build@{id(j)}#" in e.tag), None)
            if victim is None:
                raise
            # demote the oversized build's join out of the chain; it
            # re-plans through the partitioned (spilled) join
            self._force_expanding.add(victim)
            yield from self._pages_impl(node)
            return
        mem = self._mem
        leaf = self._chain_leaf(node)
        if isinstance(leaf, UnnestNode):
            self._unnest_needed[leaf] = _leaf_columns_read(node, leaf)
        for page in self._source_pages(leaf):
            # soft: an in-flight split cannot spill; the split size
            # bounds it, not the pool
            tag = mem.reserve("scan_page", page_bytes(page), enforce=False) \
                if mem is not None else None
            try:
                yield stage(page)
            finally:
                if tag is not None:
                    mem.free(tag)  # also when LIMIT closes the chain early

    def _chain_joins(self, node: PlanNode) -> List[JoinNode]:
        """The streaming joins fused into the chain of ``node``."""
        out: List[JoinNode] = []
        while True:
            if isinstance(node, JoinNode) and self._streaming(node):
                out.append(node)
                node = node.left
            elif isinstance(node, (FilterNode, ProjectNode, CrossSingleNode)) or (
                    isinstance(node, AggregationNode) and node.step == "partial"):
                node = node.sources[0]
            else:
                return out

    def _chain_leaf(self, node: PlanNode) -> PlanNode:
        if isinstance(node, (FilterNode, ProjectNode)):
            return self._chain_leaf(node.source)
        if isinstance(node, AggregationNode) and node.step == "partial":
            return self._chain_leaf(node.source)
        if isinstance(node, JoinNode) and self._streaming(node):
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
        if isinstance(node, JoinNode) and self._streaming(node):
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
        sample = node.sample
        produced = 0
        for split in splits:
            if node.limit is not None and produced >= node.limit:
                break  # pushed-down LIMIT satisfied: the rest is not read
            if sample is not None and sample[0] == "system" \
                    and system_sample_drops(split, sample[1]):
                continue
            if td is not None and not td.overlaps_split_stats(
                    conn.split_stats(node.handle.table, split)):
                continue  # split statistics prove no row matches
            page = conn.page_for_split(node.handle.table, split)
            page = Page(tuple(page.blocks[i] for i in idx), page.row_mask).to(self.device)
            if sample is not None and sample[0] == "bernoulli":
                page = Page(page.blocks, page.row_mask & bernoulli_keep(
                    page.capacity, split, sample[1], page.device))
            if node.limit is not None:
                produced += int(page.row_mask.sum())  # counted on the host, per split
            yield page

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
            self._account("join_build", build.page, node)
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
        rows, NULL-extended on the probe side.  A build past the pool
        falls back to the partitioned join."""
        if node in self._force_expanding:
            yield from self._partitioned_join_pages(node)
            return
        try:
            build = self._materialize_build(node)
        except ExceededMemoryLimitError as e:
            if f"join_build@{id(node)}#" not in e.tag:
                raise
            yield from self._partitioned_join_pages(node)
            return
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

    def _spill(self, pages: Iterator[Page], key_exprs, key_domains) -> List[List[HostPage]]:
        """Every page of ``pages`` split by key into the runner's host
        buckets (K11)."""
        num = self.spill_partitions
        bucket_fn = make_bucket_fn(key_exprs, key_domains, num)
        buckets: List[List[HostPage]] = [[] for _ in range(num)]
        for p in pages:
            for k, hp in enumerate(partition_to_host(p, bucket_fn(p), num, self._spilled)):
                if hp is not None:
                    buckets[k].append(hp)
        return buckets

    def _global_null_flags(self, bbuckets: List[List[HostPage]], right_keys) -> torch.Tensor:
        """The build's three-valued IN flags over every partition: host
        side from the spilled valids when every key is a column, else
        ``build_null_flags`` (K4) over each rehydrated bucket page."""
        has_null = torch.zeros((), dtype=torch.bool, device=self.device)
        nonempty = torch.zeros((), dtype=torch.bool, device=self.device)
        plain = all(isinstance(k, ColumnRef) for k in right_keys)
        for hp in (hp for bucket in bbuckets for hp in bucket):
            if plain:
                all_valid = torch.ones(hp.mask.shape[0], dtype=torch.bool)
                for k in right_keys:
                    all_valid &= hp.columns[k.index][1]
                has_null = has_null | bool(torch.any(hp.mask & ~all_valid))
                nonempty = nonempty | bool(torch.any(hp.mask))
            else:
                h, ne = build_null_flags(hp.rehydrate(self.device), right_keys)
                has_null = has_null | h
                nonempty = nonempty | ne
        return torch.stack([has_null, nonempty]).to(torch.int32)

    def _partitioned_join_pages(self, node: JoinNode) -> Iterator[Page]:
        """Spilled join: both sides split by join key into host buckets
        (K11), then each partition joins on its own on the device, so
        the build state is bounded by the largest partition.  semi, anti
        and mark probe through K5 against the partition's build with the
        GLOBAL three-valued flags; the other kinds expand (K8), a FULL
        join with its unmatched tail per partition."""
        kd = node.key_domains
        left_keys, right_keys = list(node.left_keys), list(node.right_keys)
        is_full = node.kind == "full"
        kind = "left" if is_full else node.kind
        ns = node.null_safe_keys
        bbuckets = self._spill(self._pages(node.right), right_keys, kd)
        pbuckets = self._spill(self._pages(node.left), left_keys, kd)
        presence = kind in ("semi", "anti", "mark")
        na = node.null_aware and presence
        flags = self._global_null_flags(bbuckets, right_keys) if na else None
        probe_spec = [(c.type, c.dictionary) for c in node.left.channels]
        for k in range(self.spill_partitions):
            if not pbuckets[k] and not (is_full and bbuckets[k]):
                continue
            bpage = concat_pages_device([hp.rehydrate(self.device) for hp in bbuckets[k]]) \
                if bbuckets[k] else Page.empty(node.right.output_types, 1, self.device)
            build = build_join(bpage, right_keys, key_domains=kd, null_safe=ns)
            if na:
                build = dataclasses.replace(build, flags=flags)
            tag = self._mem.reserve(f"join_build_partition@{id(node)}", page_bytes(build.page)) \
                if self._mem is not None else None
            try:
                matched = None
                for hp in pbuckets[k]:
                    p = hp.rehydrate(self.device)
                    if presence:
                        yield probe_join(build, p, left_keys, key_domains=kd, kind=kind,
                                         null_safe=ns, null_aware=na)
                        continue
                    res = probe_expand(build, p, left_keys, key_domains=kd, kind=kind,
                                       return_matched=is_full, null_safe=ns)
                    yield res[0]
                    if is_full:
                        matched = res[2] if matched is None else matched | res[2]
                if is_full:
                    if matched is None:
                        matched = torch.zeros(build.page.capacity, dtype=torch.bool,
                                              device=self.device)
                    yield outer_build_tail(build, matched, probe_spec)
            finally:
                if tag is not None:
                    self._mem.free(tag)  # the partition is done; its build leaves

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
        per-split partials once; then finalize.  An accumulator past the
        pool re-runs partitioned."""
        if node.step == "final":
            raise NotPorted("final aggregation over exchanged partial states")
        try:
            out = self._aggregate(node, self._pages(self.partial_node(node)))
        except ExceededMemoryLimitError as e:
            if f"agg_accumulator@{id(node)}#" not in e.tag:
                raise
            out = self._run_aggregation_spilled(node)
        return self._groupid_empty_fixup(node, out)

    def _groupid_empty_fixup(self, node: AggregationNode, out: Page) -> Page:
        """GROUPING SETS over no input row (the reference's
        ``_groupid_empty_fixup``): each set with no key (ROLLUP's and
        CUBE's grand total) still emits its one global row, count 0 and
        NULL for every other aggregate, where the grouping found no
        group."""
        src = node.source
        if not isinstance(src, GroupIdNode):
            return out
        empty_gids = [gid for gid, m in enumerate(src.set_masks) if not any(m)]
        if not empty_gids or int(out.row_mask.sum()) > 0:
            return out
        import numpy as np

        nkeys = len(node.group_exprs) - 1  # the last group expression is $group_id
        k = len(empty_gids)
        cols, valids = [], []
        for i, t in enumerate(node.output_types):
            if i == nkeys:
                cols.append(np.asarray(empty_gids, t.np_dtype))
                valids.append(np.ones(k, np.bool_))
                continue
            cols.append(np.zeros((k,) + t.value_shape, t.np_dtype))
            counts = i > nkeys and node.aggs[i - nkeys - 1].fn in ("count", "count_star")
            valids.append(np.full(k, counts, np.bool_))
        return Page.from_arrays(cols, node.output_types, valids=valids,
                                dictionaries=[c.dictionary for c in node.channels],
                                device=self.device)

    def _run_aggregation_spilled(self, node: AggregationNode) -> Page:
        """Partitioned aggregation: the source rows split by group key
        into host buckets (K11), each bucket aggregated to completion on
        the device on its own (partials, fold or merge, finalize; not
        charged: spill state must not trip the pool it relieves), and
        the bucket outputs concatenated.  A group's rows share a bucket
        and keep their order, so a presorted source stays presorted."""
        buckets = self._spill(self._pages(node.source), list(node.group_exprs),
                              node.key_domains)
        mg = self._max_groups(node)
        outs = []
        for bucket in buckets:
            if bucket:
                parts = (grouped_aggregate(hp.rehydrate(self.device), list(node.group_exprs),
                                           list(node.aggs), mg, key_domains=node.key_domains,
                                           mode="partial", presorted=node.presorted)
                         for hp in bucket)
                outs.append(self._aggregate(node, parts, account=False))
        if not outs:
            return self._aggregate(node, iter(()), account=False)
        return concat_pages_device(outs)

    def _aggregate(self, node: AggregationNode, partials: Iterator[Page],
                   account: bool = True) -> Page:
        """The fold (or merge) and finalize of ``node`` over its partial
        pages, the accumulator charged as ``agg_accumulator@id`` when
        ``account``, from its first page until the output exists (then
        the accumulator is dropped, and its reservation with it)."""
        tags: List[str] = []
        try:
            return self._fold_and_finalize(node, partials, tags if account else None)
        finally:
            for tag in tags:
                if tag is not None:
                    self._mem.free(tag)

    def _fold_and_finalize(self, node: AggregationNode, partials: Iterator[Page],
                           tags: Optional[List[str]]) -> Page:
        mg = self._max_groups(node)
        num_keys = len(node.group_exprs)
        aggs = list(node.aggs)
        # presorted partials stream (K6's presorted mode, in page order),
        # so a group cut by a split boundary comes out of two splits and
        # meets itself in the merge, as the sort path's partials do
        sort_path = takes_sort_path(node.group_exprs, node.key_domains, mg, aggs,
                                    node.presorted)
        if sort_path:
            parts = list(partials)
            if not parts:
                return Page.empty(node.output_types, 1, self.device)
            merged_in = concat_pages_device(parts)
            if tags is not None:
                tags.append(self._account("agg_accumulator", merged_in, node))
            return merge_aggregate(merged_in, num_keys, aggs, mg,
                                   key_domains=node.key_domains, mode="single")
        acc: Optional[Page] = None
        for p in partials:
            if acc is None:
                acc = p
                if tags is not None:
                    tags.append(self._account("agg_accumulator", acc, node))
            else:
                acc = combine_packed_states(acc, p, num_keys, aggs)
        if acc is None:
            if node.group_exprs:
                return Page.empty(node.output_types, max(mg, 1), self.device)
            # a global aggregation over no input still emits its row
            # (count 0, other aggregates NULL)
            empty = Page.empty(node.source.output_types, 1, self.device)
            return grouped_aggregate(empty, [], aggs, 1, mode="single")
        return finalize_packed(acc, num_keys, aggs)
