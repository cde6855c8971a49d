"""Memory accounting against the card's device-memory budget.

Counterpart of ``presto_tpu/memory.py``: tagged byte reservations in a
pool with a hard limit (``MemoryPool``), a per-query view that tags
each allocation site and frees them all at query end
(``QueryMemoryContext``), and the process-wide default pool that every
runner takes unless it brings its own.  The accountable objects are
materialized device intermediates: join builds, aggregation
accumulators, sort inputs and (softly) scan pages.  A reservation past
the limit raises :class:`ExceededMemoryLimitError`; the executor's
spill fallbacks catch it only for their own plan node's tag.

The reference's pool gauges (``wire_pool_gauges``) and resource
timeline wait for the port of ``obs/``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class QueryKilledError(Exception):
    """Raised at the next reservation of a query the memory manager
    killed: the execution thread's interruption point."""


class ExceededMemoryLimitError(Exception):
    def __init__(self, tag: str, requested: int, reserved: int, limit: int):
        super().__init__(
            f"query exceeded memory limit: {tag} requested {requested} bytes, "
            f"{reserved} reserved, limit {limit}"
        )
        self.tag = tag
        self.requested = requested
        self.reserved = reserved
        self.limit = limit


def page_bytes(page) -> int:
    """Accountable device footprint of a Page: its blocks' data and
    validity and its row mask."""
    total = 0
    for b in page.blocks:
        total += b.data.numel() * b.data.element_size()
        total += b.valid.numel() * b.valid.element_size()
    total += page.row_mask.numel() * page.row_mask.element_size()
    return total


class MemoryPool:
    """Tagged byte reservations with a hard limit (one card, one
    pool)."""

    def __init__(self, limit_bytes: int):
        self.limit = int(limit_bytes)
        self._lock = threading.Lock()
        self._tagged: Dict[str, int] = {}
        self.reserved = 0
        self.peak = 0
        self._killed: set = set()

    def reserve(self, tag: str, nbytes: int, enforce: bool = True) -> None:
        """``enforce=False`` counts the bytes (peak and attribution)
        without failing past the limit: for transient streaming state
        that cannot be spilled or retried (in-flight scan pages),
        bounded by split capacity rather than by the pool."""
        with self._lock:
            qid = tag.split("/", 1)[0]
            if qid in self._killed:
                raise QueryKilledError(f"query {qid} killed by the memory manager")
            if enforce and self.reserved + nbytes > self.limit:
                raise ExceededMemoryLimitError(tag, nbytes, self.reserved, self.limit)
            self._tagged[tag] = self._tagged.get(tag, 0) + nbytes
            self.reserved += nbytes
            self.peak = max(self.peak, self.reserved)

    def kill_query(self, query_id: str) -> int:
        """Free a query's reservations now and fail its later reserves;
        returns the bytes freed."""
        freed = 0
        with self._lock:
            self._killed.add(query_id)
            for tag in [t for t in self._tagged if t.split("/", 1)[0] == query_id]:
                freed += self._tagged.pop(tag)
            self.reserved -= freed
        return freed

    def free(self, tag: str) -> None:
        with self._lock:
            n = self._tagged.pop(tag, 0)
            self.reserved -= n

    def tags(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._tagged)


class QueryMemoryContext:
    """Per-query view over a pool: a unique tag per allocation
    (``"{query_id}/{what}#{seq}"``), freed together at query end, with
    the query's own reserved/peak bytes and the current and peak bytes
    of each site (``what``, which for an operator's reservation embeds
    its plan node's id)."""

    def __init__(self, pool: MemoryPool, query_id: str = "q"):
        self.pool = pool
        self.query_id = query_id
        self._lock = threading.Lock()
        self._seq = 0
        self.reserved = 0
        self.peak = 0
        self._tag_site: Dict[str, tuple] = {}  # tag -> (site, nbytes)
        self._site_current: Dict[str, int] = {}
        self.site_peak: Dict[str, int] = {}

    def reserve(self, what: str, nbytes: int, enforce: bool = True) -> str:
        with self._lock:
            self._seq += 1
            tag = f"{self.query_id}/{what}#{self._seq}"
        # the pool enforces its limit under its own lock; a refusal must
        # not leave this context locked
        self.pool.reserve(tag, nbytes, enforce=enforce)
        with self._lock:
            self.reserved += nbytes
            self.peak = max(self.peak, self.reserved)
            self._tag_site[tag] = (what, nbytes)
            cur = self._site_current.get(what, 0) + nbytes
            self._site_current[what] = cur
            if cur > self.site_peak.get(what, 0):
                self.site_peak[what] = cur
        return tag

    def free(self, tag: str) -> None:
        n = self.pool.tags().get(tag, 0)
        self.pool.free(tag)
        with self._lock:
            self.reserved -= n
            entry = self._tag_site.pop(tag, None)
            if entry is not None:
                site, nbytes = entry
                self._site_current[site] = self._site_current.get(site, 0) - nbytes

    def headroom(self) -> int:
        """Pool bytes still available."""
        return self.pool.limit - self.pool.reserved

    def release_all(self) -> None:
        for tag in list(self.pool.tags()):
            if tag.startswith(self.query_id + "/"):
                self.pool.free(tag)
        with self._lock:
            self.reserved = 0
            self._tag_site.clear()
            self._site_current.clear()


# ---------------------------------------------------------------------------
# the default (always-on) pool
# ---------------------------------------------------------------------------

_DEFAULT_POOL: Optional[MemoryPool] = None
_DEFAULT_LOCK = threading.Lock()


def detected_memory_limit() -> int:
    """Accountable-memory budget of the default pool: 90% of the card's
    memory where there is a card, half of host RAM without one.
    ``PRESTO_TPU_MEMORY_LIMIT_BYTES`` overrides it."""
    import os

    import torch

    env = os.environ.get("PRESTO_TPU_MEMORY_LIMIT_BYTES")
    if env:
        return int(env)
    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info()[1] * 0.9)
    try:
        with open("/proc/meminfo") as f:
            kb = int(next(ln for ln in f if ln.startswith("MemTotal")).split()[1])
        return kb * 1024 // 2
    except (OSError, StopIteration, ValueError):
        return 16 << 30


def default_memory_pool() -> MemoryPool:
    """Process-wide pool shared by every runner that does not bring its
    own.  Accounting is unconditional: an untracked path that works at
    a small scale runs out of device memory silently at a large one."""
    global _DEFAULT_POOL
    with _DEFAULT_LOCK:
        if _DEFAULT_POOL is None:
            _DEFAULT_POOL = MemoryPool(detected_memory_limit())
        return _DEFAULT_POOL
