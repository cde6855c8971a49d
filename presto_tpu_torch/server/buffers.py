"""Task output buffers: the shuffle server's acked page store (a copy of
``presto_tpu/server/buffers.py`` without its protocol recorder and
metrics, which wait for the port's observability).

Reference analog: ``execution/buffer/OutputBuffer.java`` (``get(bufferId,
token, maxSize)`` at :65, ``enqueue`` at :86) with ``ClientBuffer``'s
token protocol and ``OutputBufferMemoryManager``'s bounded footprint:

* pages are identified by a monotonically increasing token (their
  sequence number); a GET at token t returns pages [t, t+k) plus the
  next token — re-GETs of an unacknowledged token return the same pages
  (at-least-once delivery with client-side dedupe by token);
* acknowledge(t) frees all pages below t;
* the producer blocks when unacknowledged bytes exceed the buffer's
  cap — pull-side backpressure, the deadlock-free flow control the
  reference gets from bounded OutputBufferMemoryManager.

The payload is opaque: the HTTP tier stores serialized ``bytes`` (size
= len), the in-process streaming exchange (parallel/streams.py) stores
live Page objects with an explicit ``nbytes`` — ONE token/ack/
backpressure protocol for both transports.  ``producers`` > 1 turns
``set_complete`` into a countdown, so N concurrent producer threads
(UNION legs, per-worker pullers) can share one buffer and the consumer
sees completion only when the last one finishes.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple


class BufferAborted(Exception):
    pass


class TaskOutputBuffer:
    """One task's serialized-page output buffer."""

    def __init__(self, max_bytes: int = 64 << 20, producers: int = 1):
        self.max_bytes = max_bytes
        self._cond = threading.Condition()
        self._pages: List[Optional[object]] = []  # None = acknowledged/freed
        self._sizes: List[int] = []  # parallel byte sizes (payload-agnostic)
        self._acked = 0  # tokens below this are freed
        self._bytes = 0  # unacknowledged payload bytes
        self._producers = producers  # set_complete calls until complete
        self._complete = False
        self._aborted = False
        self._error: Optional[str] = None

    # -- producer side ------------------------------------------------------
    def enqueue(self, page: object, nbytes: Optional[int] = None) -> None:
        size = len(page) if nbytes is None else int(nbytes)
        with self._cond:
            while self._bytes >= self.max_bytes and not self._aborted:
                self._cond.wait(timeout=1.0)
            if self._aborted:
                raise BufferAborted()
            self._pages.append(page)
            self._sizes.append(size)
            self._bytes += size
            self._cond.notify_all()

    def set_complete(self) -> None:
        with self._cond:
            self._producers -= 1
            if self._producers <= 0:
                self._complete = True
            self._cond.notify_all()

    def fail(self, message: str) -> None:
        with self._cond:
            self._error = message
            self._complete = True
            self._cond.notify_all()

    def abort(self) -> bool:
        """Tear down the buffer, waking blocked producers/consumers.

        Idempotent and drain-safe: a second abort, or an abort racing
        a consumer's final acknowledge (complete stream, every page
        acked), is a no-op — a deadline/cancel kill arriving after the
        query already delivered everything must not retroactively fail
        it (INV exchange.abort-after-drain-noop).  Returns whether
        this call actually aborted the buffer.
        """
        with self._cond:
            drained = (self._complete and self._bytes == 0
                       and self._acked >= len(self._pages))
            changed = not self._aborted and not drained
            if not changed:
                return False
            self._aborted = True
            self._pages = []
            self._sizes = []
            self._bytes = 0
            self._cond.notify_all()
            return True

    # -- consumer side ------------------------------------------------------
    def get(self, token: int, max_bytes: int = 8 << 20,
            timeout: float = 10.0) -> Tuple[List[object], int, bool, Optional[str]]:
        """(pages, next_token, buffer_complete, error): long-polls up to
        ``timeout`` for data at ``token``; tokens below the acknowledged
        watermark cannot be replayed (the client already saw them)."""
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout
        with self._cond:
            if self._aborted:
                raise BufferAborted()
            if token < self._acked:
                raise KeyError(f"token {token} already acknowledged")
            if not self._complete and token >= len(self._pages):
                self._cond.wait(timeout=deadline)
            if self._aborted:
                raise BufferAborted()
            out: List[object] = []
            t = token
            size = 0
            while t < len(self._pages):
                p = self._pages[t]
                if p is None:  # freed (should not happen above _acked)
                    t += 1
                    continue
                if out and size + self._sizes[t] > max_bytes:
                    break
                out.append(p)
                size += self._sizes[t]
                t += 1
            done = self._complete and t >= len(self._pages)
            return out, t, done, self._error

    def acknowledge(self, token: int) -> None:
        with self._cond:
            for i in range(self._acked, min(token, len(self._pages))):
                if self._pages[i] is not None:
                    self._bytes -= self._sizes[i]
                    self._pages[i] = None
            self._acked = max(self._acked, token)
            self._cond.notify_all()
