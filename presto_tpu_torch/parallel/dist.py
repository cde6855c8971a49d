"""Distributed query execution over a mesh of shards.

Counterpart of ``presto_tpu/parallel/dist.py`` (the distributed tier:
``PlanFragmenter.java:84`` stage boundaries, per-node tasks and the
shuffle).  A stage is one program over the mesh's n shards; "tasks" are
the shards; the shuffle is an all-to-all (``parallel/mesh.py``) of
pages bucketized by K21; the scheduler is the wave loop feeding each
shard one split per wave (shard d takes split w*n + d).

Where the reference ``jax.jit``s a ``shard_map`` body per stage, the
port runs the body as a loop over the shards' pages (a list of n
pages), with the mesh's collectives as barriers between its phases;
where it stacks per-device pages on a leading axis and gathers shard
outputs to the host, the port keeps lists of device pages and
concatenates them on the device.  The wave loop is serial, and so is
the exchange between stages (its producers run inline).

Supported distributed shape: aggregation stages (scan -> chain ->
partial states -> exchange on the group keys -> final merge, K6),
streaming-chain stages (with a consuming TopN/Limit bounding each
shard's output), the sort stage (per-shard sorted runs merged by K22),
the window stage (rows routed to shards by PARTITION BY, K11, then K10
per shard) and the union stage, over BROADCAST (replicated), FIXED_HASH
(the probe rows exchanged on the join key inside the wave) and
colocated joins.  Anything else falls back to the local runner, loudly:
the reason is on ``last_fallback_reason`` and on the result's
``dist_fallback``.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from presto_tpu_torch import NotPorted
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.exec.local import LocalRunner, MaterializedResult, _is_streaming_join
from presto_tpu_torch.expr.ir import ColumnRef
from presto_tpu_torch.ops.aggregate import (
    TOPN_FNS, combine_packed_states, grouped_aggregate, raw_extremes,
    takes_sort_path,
)
from presto_tpu_torch.ops.join import JoinBuild, build_join, probe_expand, probe_join
from presto_tpu_torch.page import (
    Block, Page, concat_pages_device, cross_append_single, remap_union_leg_page,
)
from presto_tpu_torch.parallel.exchange import exchange_page, shard_buckets
from presto_tpu_torch.parallel.fragment import DEFAULT_BROADCAST_THRESHOLD
from presto_tpu_torch.parallel.mesh import Mesh, make_mesh
from presto_tpu_torch.planner.plan import (
    AggregationNode,
    CrossSingleNode,
    FilterNode,
    JoinNode,
    PlanNode,
    PrecomputedNode,
    ProjectNode,
    TableScanNode,
    TopNNode,
)
from presto_tpu_torch.session import Session

_log = logging.getLogger("presto_tpu_torch.dist")


class DistributedUnsupported(Exception):
    pass


class _CapacityBumped(Exception):
    """A probe exchange's bucket overfilled; its capacity grew and the
    stage re-runs (the reference's ``GroupCapacityExceeded`` retry)."""


def _pow2_at_least(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


class _ChainCtx:
    """Build-time context for a distributed chain: registered join
    builds (broadcast consts vs sharded consts) and the runtime check
    names the host verifies after the waves."""

    def __init__(self):
        self.broadcast: Dict[str, PlanNode] = {}
        self.sharded: Dict[str, PlanNode] = {}
        self.checks: List[Tuple[str, PlanNode]] = []  # (name, join) of each fill check
        self._i = 0

    def add_broadcast(self, node) -> str:
        key = f"build_{self._i}"
        self._i += 1
        self.broadcast[key] = node
        return key

    def add_sharded(self, node) -> str:
        key = f"sbuild_{self._i}"
        self._i += 1
        self.sharded[key] = node
        return key

    def add_check(self, node) -> str:
        name = f"fill_{len(self.checks)}"
        self.checks.append((name, node))
        return name


class _StageSource:
    """Wave-page provider for a stage leaf (the split-scheduling
    analog): a table scan reads connector splits (shard d takes split
    w*n+d, honoring a restricted ``splits`` assignment); a materialized
    intermediate (PrecomputedNode, the output of an upstream stage)
    chunks its page rows across the shards, the RemoteSourceNode role
    between fragments.  A shard without a split in a wave gets an
    empty one-row page."""

    def __init__(self, runner: "DistributedRunner", leaf):
        self.runner = runner
        self.leaf = leaf
        self.n = runner.n
        self.device = runner.device
        if isinstance(leaf, TableScanNode):
            self.conn = runner.catalog.connector(leaf.handle.connector_name)
            self.cap = runner._split_capacity(self.conn, leaf.handle.table)
            if leaf.splits is not None:
                self.split_ids = list(leaf.splits)
            else:
                num = (self.conn.num_splits(leaf.handle.table)
                       if hasattr(self.conn, "num_splits") else leaf.handle.num_splits)
                self.split_ids = list(range(num))
            self.col_idx = list(leaf.columns)
            self._pre = None
        else:
            self._pre = leaf.page.to(self.device)
            total = self._pre.capacity
            per = max(-(-total // self.n), 1)
            self.cap = _pow2_at_least(per)
            self.split_ids = list(range(max(-(-total // self.cap), 1)))
        self.n_splits = len(self.split_ids)
        self.waves = math.ceil(self.n_splits / self.n)

    def _page_for(self, i: int) -> Page:
        if self._pre is None:
            pg = self.conn.page_for_split(self.leaf.handle.table, self.split_ids[i])
            return Page(tuple(pg.blocks[c] for c in self.col_idx), pg.row_mask).to(self.device)
        lo = self.split_ids[i] * self.cap
        hi = lo + self.cap
        pre = self._pre
        return Page(tuple(Block(b.data[lo:hi], b.valid[lo:hi], b.type, b.dictionary)
                          for b in pre.blocks), pre.row_mask[lo:hi])

    def _empty_page(self) -> Page:
        if self._pre is None:
            cols = [self.leaf.handle.columns[c] for c in self.col_idx]
            pg = Page.empty([c.type for c in cols], 1, self.device)
            return Page(tuple(Block(b.data, b.valid, b.type, c.dictionary)
                              for b, c in zip(pg.blocks, cols)), pg.row_mask)
        pre = self._pre
        return Page(tuple(Block(torch.zeros_like(b.data[:1]), torch.zeros_like(b.valid[:1]),
                                b.type, b.dictionary) for b in pre.blocks),
                    torch.zeros_like(pre.row_mask[:1]))

    def wave(self, w: int) -> List[Page]:
        """Wave ``w``'s page of every shard (shard d takes split w*n + d;
        a missing split is an empty page)."""
        out = []
        for d in range(self.n):
            s = w * self.n + d
            out.append(self._page_for(s) if s < self.n_splits else self._empty_page())
        return out


class DistributedRunner:
    """Runs plans over a mesh of shards; falls back to the local runner
    when the plan shape is not distributable."""

    def __init__(
        self,
        catalog: Catalog,
        mesh: Optional[Mesh] = None,
        broadcast_threshold: int = DEFAULT_BROADCAST_THRESHOLD,
        session=None,
        memory_pool=None,
    ):
        session = session if session is not None else Session()
        if session.get("exchange_streaming"):
            # parallel/streams.py: the exchange's producers run inline
            raise NotPorted("exchange_streaming: a threaded exchange producer")
        self.catalog = catalog
        self.mesh = mesh if mesh is not None else make_mesh(session=session)
        self.broadcast_threshold = broadcast_threshold
        # session controls (SystemSessionProperties analogs)
        self.join_distribution_type = session.get("join_distribution_type")
        self.allow_colocated = bool(session.get("colocated_join"))
        self.min_stage_rows = int(session.get("distributed_min_stage_rows"))
        self.merge_fanin = max(2, int(session.get("exchange_merge_fanin")))
        self.subplan_cache_enabled = bool(session.get("subplan_cache_enabled"))
        self.local = LocalRunner(catalog, device=self.device, memory_pool=memory_pool)
        # the runner that builds stages and join builds outside a query's
        # memory context (its builds live for one query)
        self._stage_runner = LocalRunner(catalog, device=self.device)
        self._join_cfg: Dict[PlanNode, Dict[str, int]] = {}
        self._sharded_builds: Dict[Tuple, List[JoinBuild]] = {}
        self.last_stage_count = 0
        self.last_fallback_reason: Optional[str] = None

    @property
    def n(self) -> int:
        return self.mesh.n

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # ------------------------------------------------------------------
    def run(self, plan: PlanNode, stats=None) -> MaterializedResult:
        """Execute distributed; on an undistributable plan fall back to
        the local runner LOUDLY: the reason is logged, kept on
        ``last_fallback_reason`` and on the result's ``dist_fallback``.
        ``stats`` collects the local runner's per-operator actuals and
        each mesh stage's output rows."""
        if self.subplan_cache_enabled:
            # the reference's fragment cache at the exchange boundary
            raise NotPorted("subplan cache")
        self.last_stage_count = 0
        self.last_fallback_reason = None
        self.local.stats = stats
        try:
            out = self._run_distributed(plan, stats)
            out.dist_fallback = None
            return out
        except DistributedUnsupported as e:
            reason = str(e) or type(e).__name__
            self.last_fallback_reason = reason
            _log.warning("distributed execution fell back to the local runner: %s", reason)
            out = self.local.run(plan)
            out.dist_stages = 0
            out.dist_fallback = reason
            return out
        finally:
            self.local.stats = None

    def _run_distributed(self, plan: PlanNode, qstats=None) -> MaterializedResult:
        """Stage-DAG execution (PlanFragmenter.java:84 +
        SqlQueryScheduler.java:441 analog): ``lower_stages`` decomposes
        the plan bottom-up into mesh stages, whose leaves are table scans
        or the materialized output of an earlier stage, with glue
        breakers evaluated locally between stages; the residual plan
        runs on the local runner over the spliced results."""
        from presto_tpu_torch.parallel.fragment import (
            lower_stages, set_child, undistributable_reason,
        )

        # fresh join builds per query: table data may have changed
        self._stage_runner._builds.clear()
        self._sharded_builds.clear()

        def staged(run):
            """A stage runner for ``lower_stages``: the stage's page as a
            PrecomputedNode, its output rows recorded in ``qstats``."""
            def go(node, *args):
                t0 = time.perf_counter()
                page = run(node, *args)
                if qstats is not None and qstats.actual_rows(node) is None:
                    qstats.record(node, time.perf_counter() - t0, int(page.num_rows()))
                return PrecomputedNode(page=page, channel_list=node.channels)
            return go

        def eval_glue(node: PlanNode) -> PrecomputedNode:
            return PrecomputedNode(page=self.local.run_to_page(node), channel_list=node.channels)

        splices: List = []
        try:
            n_stages, root = lower_stages(
                plan, staged(self.run_aggregation_stage), staged(self.run_chain_stage),
                eval_glue, splices, min_stage_rows=self.min_stage_rows,
                run_window=staged(self.run_window_stage), run_sort=staged(self.run_sort_stage),
                run_union=staged(self.run_union_stage))
            if n_stages == 0:
                raise DistributedUnsupported(undistributable_reason(plan))
            self.last_stage_count = n_stages
            out = self.local.run(root)
            if root is not plan:  # the whole plan was one stage
                out.names, out.types = plan.output_names, plan.output_types
            out.dist_stages = n_stages
            return out
        finally:
            for parent, slot, old in reversed(splices):
                set_child(parent, slot, old)

    # ------------------------------------------------------------------
    # streaming-chain stages
    # ------------------------------------------------------------------
    def run_chain_stage(self, chain_root: PlanNode, bound=None) -> Page:
        """Wave-execute a streaming chain over the mesh and gather its
        rows (a SOURCE fragment whose consumer is the local runner or a
        glue breaker).  ``bound`` is a consuming TopN/Limit node: each
        shard then keeps only its own top/first ``bound.count`` rows
        (CreatePartialTopN.java's role; the global pick stays local)."""
        source = self._stage_source(chain_root)
        while True:
            try:
                pages = self._run_chain_stage_once(chain_root, source, bound)
                break
            except _CapacityBumped:
                continue  # a probe exchange bucket grew; re-execute
        if not pages:
            return Page.empty([c.type for c in chain_root.channels], 1, self.device)
        return concat_pages_device(pages)

    def _consts(self, ctx: _ChainCtx) -> dict:
        """The stage's join builds: one replicated build (or one-row
        relation) per broadcast join, a list of per-shard builds per
        sharded or colocated join."""
        runner = self._stage_runner
        consts = {key: (runner._single_row(j) if isinstance(j, CrossSingleNode)
                        else runner._materialize_build(j))
                  for key, j in ctx.broadcast.items()}
        for key, j in ctx.sharded.items():
            consts[key] = (self._materialize_build_colocated(j)
                           if self._join_mode(j) == "colocated"
                           else self._materialize_build_sharded(j))
        return consts

    def _run_chain_stage_once(self, chain_root: PlanNode, source: _StageSource, bound=None,
                              sort=None, emit=None) -> List[Page]:
        """One attempt of a chain stage's wave loop.  ``sort`` (a SortNode
        consumer) sorts every shard's wave output, so every emitted page
        is a pre-sorted run.  ``emit`` streams each shard's page to the
        consuming stage as soon as it is verified: at once when the
        stage carries no runtime checks, after the check pass otherwise
        (an exchange-bucket overflow re-runs the stage)."""
        from presto_tpu_torch.ops.sort import limit_compact_page, sort_page, topn_compact_page

        ctx = _ChainCtx()
        stage = self._build_dist_stage(chain_root, ctx)
        if bound is not None and bound.count >= source.cap:
            bound = None  # nothing to shrink
        consts = self._consts(ctx)

        def per_shard(p: Page) -> Page:
            if bound is not None:
                if isinstance(bound, TopNNode):
                    p = topn_compact_page(p, bound.sort_exprs, bound.ascending, bound.count,
                                          bound.nulls_first)
                else:
                    p = limit_compact_page(p, bound.count)
            if sort is not None:
                p = sort_page(p, list(sort.sort_exprs), list(sort.ascending), sort.nulls_first)
            return p

        out_pages: List[Page] = []
        wave_checks = []
        stream_now = emit is not None and not ctx.checks
        for w in range(source.waves):
            pages, checks = stage(source.wave(w), consts)
            wave_checks.append(checks)
            pages = [per_shard(p) for p in pages]
            if stream_now:
                for p in pages:
                    emit(p)
            else:
                out_pages.extend(pages)
        self._verify_checks(ctx, wave_checks)
        if emit is not None and not stream_now:
            for p in out_pages:
                emit(p)
            return []
        return out_pages

    # ------------------------------------------------------------------
    # breaker stages: window / sort / union run on the mesh, their
    # pages travelling through the token-acked exchange
    # (parallel/streams.py; its producers run inline)
    # ------------------------------------------------------------------
    def _exchange(self, kind: str, name: str):
        from presto_tpu_torch.parallel.streams import StreamingExchange

        return StreamingExchange(kind, name)

    def _produce_chain_into(self, chain_root: PlanNode, put, sort=None) -> None:
        """Producer body of a streamed chain stage: wave-execute and put
        the shards' pages, retrying capacity bumps internally (pages are
        only emitted once they cannot be invalidated)."""
        source = self._stage_source(chain_root)
        while True:
            try:
                self._run_chain_stage_once(chain_root, source, None, sort=sort, emit=put)
                return
            except _CapacityBumped:
                continue

    def _drain(self, ex, stream, consume) -> None:
        try:
            for item in stream.drain():
                consume(item)
        except BaseException:
            ex.abort()
            raise

    def run_sort_stage(self, node) -> Page:
        """Distributed ORDER BY: every shard sorts its wave output, the
        pre-sorted runs stream to the consumer, and a fan-in-bounded
        k-way merge (ops/merge.py, K22) folds runs as they arrive
        (MergeOperator.java:45's shape)."""
        from presto_tpu_torch.ops.merge import merge_sorted_pages

        sort_args = (list(node.sort_exprs), list(node.ascending), node.nulls_first)
        ex = self._exchange("merge", "dist:sort")
        stream = ex.stream()
        ex.run(stream, lambda st: self._produce_chain_into(node.source, st.put, sort=node))
        runs: List[Page] = []

        def consume(p):
            runs.append(p)
            if len(runs) >= self.merge_fanin:
                runs[:] = [merge_sorted_pages(runs, *sort_args)]

        self._drain(ex, stream, consume)
        if not runs:
            return Page.empty([c.type for c in node.channels], 1, self.device)
        return merge_sorted_pages(runs, *sort_args)

    def run_window_stage(self, node) -> Page:
        """Distributed window: the source chain's pages stream off the
        mesh and route on the PARTITION BY keys into one bucket per shard
        (the FIXED_HASH exchange; K11 groups each page's rows by
        bucket), then ``ops/window.py`` (K10) evaluates every shard's
        complete partitions."""
        from presto_tpu_torch.exec.spill import make_bucket_fn

        n = self.n
        ex = self._exchange("hash", "dist:window")
        stream = ex.stream()
        ex.run(stream, lambda st: self._produce_chain_into(node.source, st.put))
        bucket_fn = make_bucket_fn(list(node.partition_exprs), node.partition_domains, n)
        buckets: List[List[Page]] = [[] for _ in range(n)]
        self._drain(ex, stream, lambda p: self._route_to_buckets(p, bucket_fn(p), buckets))
        return self._window_over_buckets(node, buckets)

    @staticmethod
    def _route_to_buckets(page: Page, parts, buckets: List[List[Page]]) -> None:
        """Append each bucket's live rows of ``page``, in row order (the
        partitioned exchange write, PartitionedOutputOperator's role)."""
        _, perm, counts = parts
        pos = 0
        for k, c in enumerate(counts.cpu().tolist()):
            if c:
                idx = perm[pos:pos + c].to(torch.int64)
                buckets[k].append(Page(
                    tuple(Block(b.data.index_select(0, idx), b.valid.index_select(0, idx),
                                b.type, b.dictionary) for b in page.blocks),
                    torch.ones(c, dtype=torch.bool, device=page.device)))
            pos += c

    def _window_over_buckets(self, node, buckets: List[List[Page]]) -> Page:
        """The window functions over every shard's bucket (each shard
        holds complete partitions), concatenated."""
        from presto_tpu_torch.ops.window import window_page

        src_types = node.source.output_types
        outs = []
        for parts in buckets:
            page = concat_pages_device(parts) if parts else Page.empty(src_types, 1, self.device)
            if not parts:
                page = Page(tuple(Block(b.data, b.valid, b.type, ch.dictionary)
                                  for b, ch in zip(page.blocks, node.source.channels)),
                            page.row_mask)
            outs.append(window_page(page, list(node.partition_exprs), list(node.order_exprs),
                                    list(node.ascending), list(node.funcs),
                                    partition_domains=node.partition_domains))
        return concat_pages_device(outs)

    def run_union_stage(self, node) -> Page:
        """UNION ALL as producer stages draining into ONE exchange: the
        legs' waves run back to back (the shards are shared), their pages
        passing through the exchange to the dictionary-offset mapping
        and the concat."""
        from presto_tpu_torch.parallel.fragment import is_agg_stage
        from presto_tpu_torch.parallel.streams import page_nbytes

        chans = node.channels
        offsets = node.code_offsets
        ex = self._exchange("union", "dist:union")
        stream = ex.stream()

        def produce(st):
            for k, leg in enumerate(node.inputs):
                def put(p, k=k):
                    st.put((k, p), nbytes=page_nbytes(p))

                if is_agg_stage(leg, self.min_stage_rows):
                    put(self.run_aggregation_stage(leg))
                else:
                    self._produce_chain_into(leg, put)

        ex.run(stream, produce)
        out: List[Page] = []
        self._drain(ex, stream,
                    lambda item: out.append(remap_union_leg_page(item[1], offsets[item[0]], chans)))
        if not out:
            return Page.empty([c.type for c in chans], 1, self.device)
        return concat_pages_device(out)

    # ------------------------------------------------------------------
    # aggregation stages
    # ------------------------------------------------------------------
    def run_aggregation_stage(self, agg: AggregationNode) -> Page:
        """Distributed scan -> chain -> partial states -> exchange on the
        group keys -> final merge; a probe exchange's overflow re-runs
        the stage at a larger bucket."""
        if any(a.fn == "evaluate_classifier_predictions" for a in agg.aggs):
            # host-finalized string output: only the local runner
            # formats it after the final merge
            raise DistributedUnsupported("evaluate_classifier_predictions is local-only")
        while True:
            try:
                return self._run_aggregation_stage_once(agg)
            except _CapacityBumped:
                continue

    def _verify_checks(self, ctx: _ChainCtx, wave_checks) -> None:
        """Host-side verification of the waves' exchange-bucket fills:
        an overfilled bucket grows its join's capacity and raises
        _CapacityBumped so the stage re-runs (fills are true counts, so
        one retry per knob suffices)."""
        peaks: Dict[str, int] = {}
        for cks in wave_checks:
            for name, fills in cks.items():
                peaks[name] = max(peaks.get(name, 0), int(torch.stack(fills).max()))
        bumped = False
        for name, jnode in ctx.checks:
            cfg = self._join_cfg[jnode]
            if peaks.get(name, 0) > cfg["bucket_cap"]:
                cfg["bucket_cap"] = _pow2_at_least(peaks[name])
                bumped = True
        if bumped:
            raise _CapacityBumped()

    def _shard_partials(self, agg: AggregationNode, parts: List[Page], mg: int) -> Page:
        """One shard's partial states over its waves: packed-direct
        partials fold slot by slot (K3), sort-path partials concatenate
        for the merge after the exchange."""
        aggs = list(agg.aggs)
        packed = not (takes_sort_path(agg.group_exprs, agg.key_domains, mg, aggs)
                      or any(a.fn in TOPN_FNS for a in aggs) or raw_extremes(aggs))
        if not packed:
            return concat_pages_device(parts)
        acc = parts[0]
        for p in parts[1:]:
            acc = combine_packed_states(acc, p, len(agg.group_exprs), aggs)
        return acc

    def _run_aggregation_stage_once(self, agg: AggregationNode) -> Page:
        n = self.n
        source = self._stage_source(agg.source)
        ctx = _ChainCtx()
        stage = self._build_dist_stage(agg.source, ctx)
        consts = self._consts(ctx)
        mg = self._stage_runner._max_groups(agg)
        group_exprs = list(agg.group_exprs)
        aggs = list(agg.aggs)
        nk = len(group_exprs)
        kd = agg.key_domains

        parts: List[List[Page]] = [[] for _ in range(n)]
        wave_checks = []
        for w in range(source.waves):
            pages, checks = stage(source.wave(w), consts)
            wave_checks.append(checks)
            for d, p in enumerate(pages):
                parts[d].append(grouped_aggregate(p, group_exprs, aggs, mg, key_domains=kd,
                                                  mode="partial"))
        self._verify_checks(ctx, wave_checks)
        if not source.waves:
            empty = Page.empty(agg.source.output_types, 1, self.device)
            parts = [[grouped_aggregate(empty, group_exprs, aggs, mg, key_domains=kd,
                                        mode="partial")] for _ in range(n)]
        accs = [self._shard_partials(agg, ps, mg) for ps in parts]

        if nk == 0:
            # one group: every shard's state gathers to the final step
            return self.local.final_aggregate(agg, accs)

        # ---- exchange on the group keys + final merge ---------------
        # (the buckets sized from the count: no state is dropped)
        key_refs = [ColumnRef(type=accs[0].blocks[i].type, index=i) for i in range(nk)]
        bucketized, _, _ = shard_buckets(accs, key_refs, n, kd)
        del accs
        received = exchange_page(bucketized)
        del bucketized
        return concat_pages_device([self.local.final_aggregate(agg, [r]) for r in received])

    # ------------------------------------------------------------------
    # distributed chain compilation (joins distribute per fragmenter)
    # ------------------------------------------------------------------
    def _dist_chain_leaf(self, node: PlanNode) -> PlanNode:
        """Chain leaf for the distributed tier: descends through ALL
        joins' probe sides (expanding joins run in the wave here)."""
        if isinstance(node, (FilterNode, ProjectNode)):
            return self._dist_chain_leaf(node.source)
        if isinstance(node, AggregationNode) and node.step == "partial":
            return self._dist_chain_leaf(node.source)
        if isinstance(node, (CrossSingleNode, JoinNode)):
            return self._dist_chain_leaf(node.left)
        return node

    def _join_mode(self, jnode) -> str:
        """The fragmenter's broadcast-vs-repartition decision (it owns
        the downgrade of non-chainable build sides, so EXPLAIN and
        execution agree)."""
        from presto_tpu_torch.parallel.fragment import decide_join_distribution

        mode, _ = decide_join_distribution(
            jnode, self.broadcast_threshold, catalog=self.catalog,
            forced=self.join_distribution_type, allow_colocated=self.allow_colocated)
        return mode

    def _build_dist_stage(self, node: PlanNode, ctx: _ChainCtx):
        """fn(pages, consts) -> (pages, checks) over the shards' pages: the
        distributed analog of LocalRunner._build_stage.  ``checks`` maps
        check names to the shards' exchange fills (int32 scalars) the
        host verifies."""
        from presto_tpu_torch.ops.filter_project import filter_page, project_page

        if isinstance(node, FilterNode):
            inner = self._build_dist_stage(node.source, ctx)
            pred = node.predicate

            def f_filter(ps, c):
                qs, ch = inner(ps, c)
                return [filter_page(q, pred) for q in qs], ch

            return f_filter

        if isinstance(node, ProjectNode):
            inner = self._build_dist_stage(node.source, ctx)
            projections = list(node.projections)

            def f_project(ps, c):
                qs, ch = inner(ps, c)
                return [project_page(q, projections) for q in qs], ch

            return f_project

        if isinstance(node, AggregationNode) and node.step == "partial":
            inner = self._build_dist_stage(node.source, ctx)
            group_exprs, aggs = list(node.group_exprs), list(node.aggs)
            pmg = self._stage_runner._max_groups(node)
            pkd = node.key_domains

            def f_pagg(ps, c):
                qs, ch = inner(ps, c)
                return [grouped_aggregate(q, group_exprs, aggs, pmg, key_domains=pkd,
                                          mode="partial") for q in qs], ch

            return f_pagg

        if isinstance(node, CrossSingleNode):
            inner = self._build_dist_stage(node.left, ctx)
            key = ctx.add_broadcast(node)

            def f_cross(ps, c):
                qs, ch = inner(ps, c)
                return [cross_append_single(q, c[key]) for q in qs], ch

            return f_cross

        if isinstance(node, JoinNode):
            if node.kind == "full":
                # the unmatched-build tail needs cross-page (and
                # cross-shard) match state; falls back to local
                raise DistributedUnsupported("full outer join")
            if node.use_index:
                raise DistributedUnsupported("index join")
            inner = self._build_dist_stage(node.left, ctx)
            mode = self._join_mode(node)
            left_keys = list(node.left_keys)
            kd, kind, ns = node.key_domains, node.kind, node.null_safe_keys
            na = node.null_aware and kind in ("semi", "anti", "mark")
            streaming = _is_streaming_join(node)

            def probe(build, q):
                if streaming:
                    return probe_join(build, q, left_keys, key_domains=kd, kind=kind,
                                      null_safe=ns, null_aware=na)
                return probe_expand(build, q, left_keys, key_domains=kd, kind=kind,
                                    null_safe=ns)[0]

            if mode == "broadcast":
                key = ctx.add_broadcast(node)

                def f_bjoin(ps, c):
                    qs, ch = inner(ps, c)
                    return [probe(c[key], q) for q in qs], ch

                return f_bjoin

            key = ctx.add_sharded(node)
            if mode == "colocated":
                # bucket-aligned sides: shard d already holds build bucket
                # w*n+d when probing split w*n+d, so neither side moves
                def f_cjoin(ps, c):
                    qs, ch = inner(ps, c)
                    return [probe(b, q) for b, q in zip(c[key], qs)], ch

                return f_cjoin

            # partitioned (repartitioned join): exchange the probe rows on
            # the join key, probe the local build shard.  The bucket
            # capacity is the join's: the first wave sizes it from its
            # count (a power of two at least its largest fill); a later
            # wave past it drops rows, and its fill re-runs the stage
            n = self.n
            cfg = self._join_cfg.setdefault(node, {})
            fill_check = ctx.add_check(node)

            def f_pjoin(ps, c):
                qs, ch = inner(ps, c)
                parts, fills, used = shard_buckets(qs, left_keys, n, kd, cfg.get("bucket_cap"))
                cfg.setdefault("bucket_cap", _pow2_at_least(used))
                del qs  # the shards' pages leave as their buckets exchange
                received = exchange_page(parts)
                del parts
                out = [probe(b, q) for b, q in zip(c[key], received)]
                return out, {**ch, fill_check: fills}

            return f_pjoin

        # chain leaf (scan): identity
        return lambda ps, c: (ps, {})

    def _stage_source(self, chain_root: PlanNode) -> _StageSource:
        leaf = self._dist_chain_leaf(chain_root)
        if not isinstance(leaf, (TableScanNode, PrecomputedNode)):
            raise DistributedUnsupported(
                f"chain leaf is {type(leaf).__name__}, not a table scan "
                "or materialized stage output")
        if isinstance(leaf, TableScanNode) and leaf.sample is not None:
            # the waves read whole splits; the sample's split and row
            # choices are the local scan's
            raise DistributedUnsupported("TABLESAMPLE scan")
        return _StageSource(self, leaf)

    # ------------------------------------------------------------------
    # sharded (repartitioned) and colocated join builds
    # ------------------------------------------------------------------
    def _build_waves(self, jnode):
        """The build side's chain over the mesh: (its stage function,
        its source)."""
        runner = self._stage_runner
        leaf_r = runner._chain_leaf(jnode.right)
        if not isinstance(leaf_r, TableScanNode):
            raise DistributedUnsupported(
                f"build leaf is {type(leaf_r).__name__}, not a table scan")
        return runner._build_stage(jnode.right), _StageSource(self, leaf_r)

    def _materialize_build_colocated(self, jnode) -> List[JoinBuild]:
        """Build side of a colocated join: shard d wave-scans its OWN
        build splits (the w*n+d placement the probe leaf uses, so bucket
        b lands where probe bucket b runs), with no exchange."""
        key = (jnode, "colocated")
        cached = self._sharded_builds.get(key)
        if cached is not None:
            return cached
        stage_r, source = self._build_waves(jnode)
        received: List[List[Page]] = [[] for _ in range(self.n)]
        for w in range(source.waves):
            for d, p in enumerate(source.wave(w)):
                received[d].append(stage_r(p))
        builds = [build_join(concat_pages_device(r), list(jnode.right_keys),
                             key_domains=jnode.key_domains, null_safe=jnode.null_safe_keys)
                  for r in received]
        self._sharded_builds[key] = builds
        return builds

    def _materialize_build_sharded(self, jnode) -> List[JoinBuild]:
        """Build side of a repartitioned join: wave-scan the build chain
        over the mesh, exchange its rows on the join key (each wave's
        buckets sized from its count), then build one join table per
        shard over its key partition: shard p holds the build rows whose
        key's target is p (the PartitionedLookupSourceFactory role)."""
        key = (jnode, "sharded")
        cached = self._sharded_builds.get(key)
        if cached is not None:
            return cached
        n = self.n
        stage_r, source = self._build_waves(jnode)
        right_keys = list(jnode.right_keys)
        kd = jnode.key_domains
        received: List[List[Page]] = [[] for _ in range(n)]
        for w in range(source.waves):
            parts, _, _ = shard_buckets([stage_r(p) for p in source.wave(w)], right_keys, n, kd)
            for d, r in enumerate(exchange_page(parts)):
                received[d].append(r)
        if not source.waves:
            received = [[Page.empty(jnode.right.output_types, 1, self.device)] for _ in range(n)]
        builds = [build_join(concat_pages_device(r), right_keys, key_domains=kd,
                             null_safe=jnode.null_safe_keys) for r in received]
        self._sharded_builds[key] = builds
        return builds

    # ------------------------------------------------------------------
    def _split_capacity(self, conn, table: str) -> int:
        if hasattr(conn, "max_split_rows"):
            return int(conn.max_split_rows(table))
        pg = conn.page_for_split(table, 0)
        return _pow2_at_least(max(pg.capacity, 2))
