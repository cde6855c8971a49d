"""In-process streaming page exchange: the pull-based, token-acked
stage boundary of the mesh tier (parallel/dist.py).  A copy of
``presto_tpu/parallel/streams.py`` without its metrics, timeline,
gauges and overlap statistics, which wait for the port's observability,
without its query-scoped kill registry, which waits for the port's
memory-pool kills, and without its producer threads (see
:class:`StreamingExchange`).

Reference analog: the consumer half of the exchange —
``operator/ExchangeClient.java:58`` pulling
``execution/buffer/OutputBuffer.java`` pages by (token, ack) long-poll
— collapsed to an in-memory :class:`TaskOutputBuffer` when producer
and consumer share a process.  A stage's producers (mesh waves, UNION
legs) enqueue pages as they materialize, and the consuming stage pulls
them by token and acknowledges them.
"""

from __future__ import annotations

from typing import Callable, Iterator, List

from presto_tpu_torch.server.buffers import TaskOutputBuffer


class StreamFailed(RuntimeError):
    """A producer failed; the consumer re-raises the original error."""


def page_nbytes(page) -> int:
    """Best-effort in-memory size of a Page (backpressure accounting)."""
    from presto_tpu_torch.memory import page_bytes

    try:
        return int(page_bytes(page))
    except (AttributeError, TypeError):
        return 1 << 12  # a payload that is not a Page: charge a nominal page


class PageStream:
    """One token-acked stream of Page payloads over an in-memory
    buffer — the in-process twin of a worker's output buffer, with the
    exact same enqueue / get(token) / acknowledge protocol."""

    def __init__(self, max_bytes: int, producers: int = 1, name: str = ""):
        self.name = name
        self.buffer = TaskOutputBuffer(max_bytes=max_bytes, producers=producers)
        self._exc = None

    # -- producer side -------------------------------------------------
    def put(self, page, nbytes=None) -> None:
        self.buffer.enqueue(page, nbytes=page_nbytes(page) if nbytes is None else int(nbytes))

    def producer_done(self) -> None:
        self.buffer.set_complete()

    def fail(self, exc: BaseException) -> None:
        if self._exc is None:
            self._exc = exc
        self.buffer.fail(f"{type(exc).__name__}: {exc}")

    def abort(self) -> bool:
        """Abort the stream; returns whether the underlying buffer
        actually aborted.  Idempotent and drain-safe (the buffer's
        abort is a no-op on a second call or after a full drain), so
        an abort racing a consumer that already finished never raises
        and never fails a query that delivered everything."""
        return self.buffer.abort()

    # -- consumer side -------------------------------------------------
    def drain(self, batch_bytes: int = 8 << 20) -> Iterator:
        """Pull + ack until complete; re-raises a producer's error.
        Closing the generator early (LIMIT, a consumer-side error)
        aborts the buffer: a producer blocked on the byte cap would
        otherwise wait for acks that can never come — the deadlock the
        sanitizer's instrumented-lock runs flagged as unbounded
        producer stalls on dead consumers."""
        token = 0
        complete = False
        try:
            while True:
                items, nxt, done, err = self.buffer.get(
                    token, max_bytes=batch_bytes, timeout=10.0)
                if err is not None:
                    raise self._exc if self._exc is not None \
                        else StreamFailed(err)
                for it in items:
                    yield it
                if nxt > token:
                    self.buffer.acknowledge(nxt)
                    token = nxt
                if done:
                    complete = True
                    return
        finally:
            if not complete:
                self.buffer.abort()


class StreamingExchange:
    """One stage boundary: producer streams feeding one consumer.
    ``kind`` names the exchange shape EXPLAIN prints (hash / gather /
    merge / union).  Every producer runs inline, to completion, before
    the consumer drains: the reference's ``exchange_streaming = false``
    leg.  Its other leg, each producer on a thread, launches onto the
    same stream of the same card as the consumer under one GIL, and
    was slower than the inline run on an H100 (PERF.md §6), so it is
    not ported."""

    def __init__(self, kind: str, name: str = ""):
        self.kind = kind
        self.name = name or kind
        self.streams: List[PageStream] = []

    def stream(self, producers: int = 1) -> PageStream:
        # the producers finish before the consumer drains, so the
        # buffer holds the whole intermediate: no byte cap may bind
        s = PageStream(max_bytes=1 << 62, producers=producers,
                       name=f"{self.name}[{len(self.streams)}]")
        self.streams.append(s)
        return s

    def run(self, stream: PageStream, produce: Callable[[PageStream], None],
            ) -> None:
        """Run one producer into ``stream``, inline, to completion; its
        error travels to the consumer through the stream."""
        try:
            produce(stream)
        except BaseException as e:
            stream.fail(e)
        finally:
            stream.producer_done()

    def abort(self) -> None:
        for s in self.streams:
            s.abort()
