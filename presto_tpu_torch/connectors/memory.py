"""In-memory (device-resident) table connector.

Counterpart of ``presto_tpu/connectors/memory.py``: tables are lists of
Pages held on the connector's device; loading from another connector
is the CTAS path.  Used to run queries without per-run host data
generation.  Writes, DDL and transactions are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch import resolve_device
from presto_tpu_torch.page import Page
from presto_tpu_torch.types import Type


class MemoryConnector:
    """``device`` holds the tables (default ``cuda``; see
    :func:`presto_tpu_torch.resolve_device`)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._tables: Dict[str, List[Page]] = {}
        self._schemas: Dict[str, List[Tuple[str, Type]]] = {}
        self._domains: Dict[str, Dict[str, Optional[Tuple[int, int]]]] = {}
        self._pks: Dict[str, Optional[List[str]]] = {}
        self._sort: Dict[str, Optional[List[str]]] = {}
        self._bucketing: Dict[str, Optional[tuple]] = {}
        self._dicts: Dict[str, Dict[str, object]] = {}

    def create_table(
        self,
        name: str,
        schema: Sequence[Tuple[str, Type]],
        pages: Sequence[Page],
        domains: Optional[Dict[str, Tuple[int, int]]] = None,
        primary_key: Optional[List[str]] = None,
        sort_order: Optional[List[str]] = None,
        bucketing: Optional[tuple] = None,
    ) -> None:
        self._tables[name] = [self._to_device(p) for p in pages]
        self._schemas[name] = list(schema)
        self._domains[name] = dict(domains or {})
        self._pks[name] = primary_key
        self._sort[name] = list(sort_order) if sort_order else None
        self._bucketing[name] = bucketing
        self._dicts[name] = {}
        for page in pages[:1]:  # a raw varchar column has no dictionary
            for (col, t), b in zip(schema, page.blocks):
                if t.is_string and not t.is_raw_string:
                    self._dicts[name][col] = b.dictionary

    def _to_device(self, page: Page) -> Page:
        """Pin a page's tensors on the connector's device once, at load:
        later scans read them in place."""
        return page.to(self.device)

    def load_from(self, conn, table: str, name: Optional[str] = None,
                  columns: Optional[List[str]] = None) -> None:
        """Copy a table from another connector onto the device (CTAS).
        ``columns`` prunes to the listed columns."""
        name = name or table
        schema = conn.schema(table)
        keep = [i for i, (c, _) in enumerate(schema)
                if columns is None or c in columns]
        pages = []
        for s in range(conn.num_splits(table)):
            p = conn.page_for_split(table, s)
            pages.append(Page(tuple(p.blocks[i] for i in keep), p.row_mask))
        pruned_schema = [schema[i] for i in keep]
        names = [n for n, _ in pruned_schema]
        domains = {}
        if hasattr(conn, "column_domain"):
            for c, _ in pruned_schema:
                domains[c] = conn.column_domain(table, c)
        pk = conn.primary_key(table) if hasattr(conn, "primary_key") else None
        if pk is not None and any(c not in names for c in pk):
            pk = None
        so = conn.sort_order(table) if hasattr(conn, "sort_order") else None
        if so is not None and any(c not in names for c in so):
            so = None
        bk = conn.bucketing(table) if hasattr(conn, "bucketing") else None
        if bk is not None and any(c not in names for c in bk[0]):
            bk = None
        self.create_table(name, pruned_schema, pages, domains, pk,
                          sort_order=so, bucketing=bk)

    def drop_table(self, name: str) -> None:
        """Forget table ``name`` (its pages' device memory goes with the
        last reference to them)."""
        for d in (self._tables, self._schemas, self._domains, self._pks, self._sort,
                  self._bucketing, self._dicts):
            d.pop(name, None)

    # -- connector protocol -------------------------------------------------
    def table_names(self) -> List[str]:
        return list(self._tables.keys())

    def schema(self, table: str) -> List[Tuple[str, Type]]:
        return self._schemas[table]

    def num_splits(self, table: str) -> int:
        return len(self._tables[table])

    def page_for_split(self, table: str, split: int, capacity: Optional[int] = None) -> Page:
        return self._tables[table][split]

    def row_count(self, table: str) -> int:
        return sum(int(p.num_rows()) for p in self._tables[table])

    def column_domain(self, table: str, column: str) -> Optional[Tuple[int, int]]:
        return self._domains.get(table, {}).get(column)

    def primary_key(self, table: str) -> Optional[List[str]]:
        return self._pks.get(table)

    def sort_order(self, table: str) -> Optional[List[str]]:
        return self._sort.get(table)

    def bucketing(self, table: str) -> Optional[tuple]:
        return self._bucketing.get(table)

    def dictionary_for(self, table: str, column: str):
        return self._dicts.get(table, {}).get(column)

    def max_split_rows(self, table: str) -> int:
        return max(p.capacity for p in self._tables[table])
