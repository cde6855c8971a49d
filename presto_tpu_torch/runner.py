"""Top-level query runner: SQL in, rows out.

Counterpart of ``presto_tpu/runner.py``: parse -> bind and plan (the
copied front end) -> execute on the port's :class:`LocalRunner`.  Only
queries (SELECT) are ported; every other statement raises
:class:`NotPorted`.
"""

from __future__ import annotations

from typing import Dict, Optional

from presto_tpu_torch import NotPorted
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.exec.local import LocalRunner, MaterializedResult, QueryStats
from presto_tpu_torch.session import Session
from presto_tpu_torch.sql import ast
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
        self.executor = LocalRunner(catalog, device=device, memory_pool=self.memory_pool)
        # repeated executions of one SQL text reuse its plan
        self._plans: Dict[str, object] = {}

    @property
    def device(self):
        return self.executor.device

    def plan(self, sql: str):
        stmt = parse_statement(sql)
        if not isinstance(stmt, (ast.Query, ast.Union, ast.With, ast.SetOp)):
            raise NotPorted(f"statement {type(stmt).__name__}")
        return self._plan_cached(sql, stmt)

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
        """Run one query; ``stats`` collects per-operator actuals."""
        plan = self.plan(sql)
        self.executor.stats = stats
        try:
            return self.executor.run(plan)
        finally:
            self.executor.stats = None
