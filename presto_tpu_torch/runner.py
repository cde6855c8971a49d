"""Top-level query runner: SQL in, rows out.

Counterpart of ``presto_tpu/runner.py``: parse -> bind and plan (the
copied front end) -> execute on the port's :class:`LocalRunner`, or,
with the session's ``distributed`` set, on the mesh tier's
:class:`~presto_tpu_torch.parallel.dist.DistributedRunner` over
``hash_partition_count`` shards of the runner's device.  Queries
(SELECT) and SET SESSION are ported; every other statement raises
:class:`NotPorted`.
"""

from __future__ import annotations

from typing import Dict, Optional

from presto_tpu_torch import NotPorted
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.exec.local import LocalRunner, MaterializedResult, QueryStats
from presto_tpu_torch.session import Session
from presto_tpu_torch.sql import ast
from presto_tpu_torch.types import VARCHAR
from presto_tpu_torch.sql.binder import BindError, Binder, annotate_position
from presto_tpu_torch.sql.parser import parse_statement


class QueryRunner:
    """Runs SQL over ``catalog`` on ``device`` (default ``cuda``; see
    :func:`presto_tpu_torch.resolve_device`).  Memory accounting is
    always on: ``memory_pool=None`` takes the process's default pool
    (:func:`presto_tpu_torch.memory.default_memory_pool`), ``False``
    turns accounting off."""

    def __init__(self, catalog: Catalog, session: Optional[Session] = None, device=None,
                 memory_pool=None):
        self.catalog = catalog
        self.session = session or Session()
        self.binder = Binder(catalog, session=self.session)
        if memory_pool is None:
            from presto_tpu_torch.memory import default_memory_pool

            memory_pool = default_memory_pool()
        self.memory_pool = memory_pool or None
        self._device = device
        self.executor = self._make_executor()
        self._dist = None  # the mesh tier, made at its first query
        # repeated executions of one SQL text reuse its plan
        self._plans: Dict[str, object] = {}

    def _make_executor(self) -> LocalRunner:
        ex = LocalRunner(self.catalog, device=self._device, memory_pool=self.memory_pool)
        ex.merge_sort = bool(self.session.get("distributed_sort"))
        return ex

    @property
    def device(self):
        return self.executor.device

    def plan(self, sql: str, stmt=None):
        """The plan of ``sql`` (``stmt``: its parse, when the caller has
        it)."""
        if stmt is None:
            stmt = parse_statement(sql)
        if not isinstance(stmt, (ast.Query, ast.Union, ast.With, ast.SetOp)):
            raise NotPorted(f"statement {type(stmt).__name__}")
        return self._plan_cached(sql, stmt)

    def _set_session(self, stmt: ast.SetSession) -> MaterializedResult:
        """SET SESSION: the executor and the mesh tier re-read their
        knobs (plans survive)."""
        self.session.set(stmt.name, stmt.value)
        self.executor = self._make_executor()
        self._dist = None
        return MaterializedResult(["result"], [VARCHAR], [("SET SESSION",)])

    def _plan_cached(self, sql: str, q):
        plan = self._plans.get(sql)
        if plan is None:
            try:
                plan = self.binder.plan_ast(q)
            except BindError as e:
                raise annotate_position(e, sql) from e.__cause__
            self._plans[sql] = plan
        return plan

    def execute(self, sql: str, stats: Optional[QueryStats] = None) -> MaterializedResult:
        """Run one statement; ``stats`` collects per-operator actuals."""
        stmt = parse_statement(sql)
        if isinstance(stmt, ast.SetSession):
            return self._set_session(stmt)
        return self._run_plan(self.plan(sql, stmt), stats)

    def _run_plan(self, plan, stats: Optional[QueryStats] = None) -> MaterializedResult:
        """Route through the mesh tier when the session's ``distributed``
        is set (it falls back to the local runner, loudly, where the
        plan shape does not distribute); otherwise the local executor."""
        if self.session.get("distributed"):
            return self._distributed().run(plan, stats=stats)
        self.executor.stats = stats
        try:
            return self.executor.run(plan)
        finally:
            self.executor.stats = None

    def _distributed(self):
        if self._dist is None:
            from presto_tpu_torch.parallel.dist import DistributedRunner
            from presto_tpu_torch.parallel.mesh import make_mesh

            self._dist = DistributedRunner(
                self.catalog, mesh=make_mesh(device=self.device, session=self.session),
                session=self.session, memory_pool=self.memory_pool)
        return self._dist

    def explain_distributed(self, sql: str) -> str:
        """EXPLAIN (TYPE DISTRIBUTED)'s text for ``sql``: the FRAGMENTED
        header (whether the plan distributes, and why not) and the
        fragment tree the mesh tier would run, under the session's
        ``distributed_min_stage_rows``."""
        from presto_tpu_torch.parallel.fragment import explain_distributed

        return explain_distributed(self.plan(sql), catalog=self.catalog,
                                   min_stage_rows=int(self.session.get(
                                       "distributed_min_stage_rows")))
