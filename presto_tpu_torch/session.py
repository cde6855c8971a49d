"""Session + system properties.

Reference analog: ``Session.java`` + ``SystemSessionProperties.java:50``
(57 typed session properties, settable per query over the wire or via
SET SESSION) and the ``@Config``-bound config beans
(execution/TaskManagerConfig.java).  One typed registry serves both
roles; connectors may register their own namespaced properties.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class PropertyMetadata:
    name: str
    description: str
    default: Any
    parse: Callable[[str], Any]


def _bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes", "on")


def _duration(s: str) -> str:
    """Validate a duration-typed property at SET time ('30s', '10m',
    plain seconds; empty = server default) — a malformed value must
    fail the SET SESSION statement, not the next query's execution."""
    s = s.strip()
    if s:
        from presto_tpu_torch import NotPorted

        raise NotPorted("duration-typed session properties")
    return s


SYSTEM_PROPERTIES = [
    PropertyMetadata(
        "jit", "compile streaming chains with XLA (debugging escape hatch)",
        True, _bool,
    ),
    PropertyMetadata(
        "distributed", "execute over the device mesh when the plan shape allows",
        False, _bool,
    ),
    PropertyMetadata(
        "hash_partition_count",
        "partitions for distributed exchanges (devices used of the mesh)",
        0, int,  # 0 = all mesh devices
    ),
    PropertyMetadata(
        "max_groups",
        "default static group-by capacity before overflow retry",
        1 << 16, int,
    ),
    PropertyMetadata(
        "split_capacity",
        "pad scan splits to this static row capacity (0 = natural size)",
        0, int,
    ),
    PropertyMetadata(
        "collect_stats",
        "record per-stage rows/wall-time (EXPLAIN ANALYZE forces this)",
        False, _bool,
    ),
    PropertyMetadata(
        "query_priority",
        "admission priority within query_priority resource groups",
        0, int,
    ),
    PropertyMetadata(
        "distributed_sort",
        "multi-producer ORDER BY: per-page sorts + order-preserving merge",
        True, _bool,
    ),
    PropertyMetadata(
        "colocated_join",
        "use bucket-aligned exchange-free joins when tables allow",
        True, _bool,
    ),
    PropertyMetadata(
        "join_distribution_type",
        "AUTOMATIC | BROADCAST | PARTITIONED (DetermineJoinDistributionType)",
        "AUTOMATIC", lambda s: s.strip().upper(),
    ),
    PropertyMetadata(
        "trace",
        "record lifecycle/operator/compile spans for every query "
        "(exportable as Chrome-trace JSON; query.trace-dir config "
        "writes one file per query)",
        False, _bool,
    ),
    PropertyMetadata(
        "validate_plans",
        "run the static plan/IR validator on every bound plan "
        "(EXPLAIN (TYPE VALIDATE) always does; query.validate-plans "
        "config key sets the default)",
        False, _bool,
    ),
    PropertyMetadata(
        "validate_rewrites",
        "gate every optimizer rule application with the rewrite-"
        "soundness checker (analysis/soundness.py; EXPLAIN (TYPE "
        "VALIDATE) always does; query.validate-rewrites config key "
        "sets the default)",
        False, _bool,
    ),
    PropertyMetadata(
        "validate_kernels",
        "run the expression-tier abstract interpreter on every bound "
        "plan: overflow, lossy-cast, division, accumulator, and "
        "null-policy soundness (analysis/kernel_soundness.py; EXPLAIN "
        "(TYPE VALIDATE) always does; query.validate-kernels config "
        "key sets the default)",
        False, _bool,
    ),
    PropertyMetadata(
        "distributed_min_stage_rows",
        "stages over intermediates smaller than this run on the "
        "coordinator (0 = every stage on the mesh)",
        1 << 13, int,
    ),
    PropertyMetadata(
        "exchange_streaming",
        "run each stage-boundary producer on a thread so consuming "
        "stages overlap it (not ported: true raises NotPorted); false = "
        "materialize each stage before the next starts",
        False, _bool,
    ),
    PropertyMetadata(
        "exchange_buffer_bytes",
        "unacknowledged-byte cap per exchange stream (the threaded "
        "producer's backpressure bound; unused while producers run "
        "inline)",
        0, int,
    ),
    PropertyMetadata(
        "exchange_merge_fanin",
        "pre-sorted runs the distributed-ORDER-BY consumer folds per "
        "k-way merge batch (bounds merge memory while runs stream in)",
        8, int,
    ),
    PropertyMetadata(
        "task_concurrency",
        "splits in flight per scan pipeline (morsel scheduler, "
        "exec/tasks.py); 1 = serial legacy path, 0 = process default "
        "(query.task-concurrency config / PRESTO_TPU_TASK_CONCURRENCY)",
        0, int,
    ),
    PropertyMetadata(
        "query_max_execution_time",
        "kill the query after this long running (duration: '30s', "
        "'10m'; empty = the coordinator's query.max-execution-time "
        "config default, '0' = no deadline)",
        "", _duration,
    ),
    PropertyMetadata(
        "task_prefetch",
        "host pages prepared ahead of the split worker pool "
        "(double-buffering depth); -1 = process default "
        "(PRESTO_TPU_TASK_PREFETCH)",
        -1, int,
    ),
    PropertyMetadata(
        "result_cache_enabled",
        "serve repeated read-only queries from the structural result "
        "cache (keyed by plan signature, invalidated by table "
        "versions; docs/serving.md — query.result-cache-enabled "
        "config sets the default, query.result-cache-bytes the budget)",
        False, _bool,
    ),
    PropertyMetadata(
        "subplan_cache_enabled",
        "reuse warm stage intermediates at exchange boundaries when a "
        "distributed stage's signature and table versions match a "
        "prior execution (docs/serving.md)",
        False, _bool,
    ),
    PropertyMetadata(
        "feedback_stats",
        "let the planner consult the plan-history store: observed row "
        "counts from prior executions override textbook selectivities "
        "on structural-signature match (obs/history.py; "
        "docs/observability.md 'Estimate vs actual')",
        False, _bool,
    ),
    PropertyMetadata(
        "misestimate_factor",
        "flag EXPLAIN ANALYZE operators whose actual/estimate row "
        "ratio exceeds this factor (either direction); also the doctor "
        "misestimate rule's evidence threshold source",
        8.0, float,
    ),
]


class Session:
    """Per-query context: properties + (later) principal/tx/trace."""

    def __init__(self, properties: Optional[Dict[str, Any]] = None, user: str = "presto",
                 trace_token: Optional[str] = None):
        self._meta = {p.name: p for p in SYSTEM_PROPERTIES}
        self.properties: Dict[str, Any] = {
            p.name: p.default for p in SYSTEM_PROPERTIES
        }
        if properties:
            for k, v in properties.items():
                self.set(k, v)
        self.user = user
        # request-correlation token (X-Presto-Trace-Token analog); one
        # is generated per query when the client supplies none
        self.trace_token = trace_token
        # USE state (Session.java catalog/schema; execution/UseTask.java
        # mutates these): unqualified names resolve against them first
        self.catalog: Optional[str] = None
        self.schema: str = "default"
        # SET PATH (sql/tree/SetPath.java): SQL function-resolution
        # path; recorded for protocol parity (one flat function
        # namespace here, so it does not affect resolution)
        self.path: str = ""

    def get(self, name: str) -> Any:
        return self.properties[name]

    def set(self, name: str, value) -> None:
        meta = self._meta.get(name)
        if meta is None:
            raise KeyError(f"unknown session property: {name}")
        if isinstance(value, str):
            value = meta.parse(value)
        self.properties[name] = value

    def reset(self, name: str) -> None:
        """RESET SESSION: back to the property's default."""
        meta = self._meta.get(name)
        if meta is None:
            raise KeyError(f"unknown session property: {name}")
        self.properties[name] = meta.default

    def describe(self):
        return [
            (p.name, self.properties[p.name], p.default, p.description)
            for p in SYSTEM_PROPERTIES
        ]
