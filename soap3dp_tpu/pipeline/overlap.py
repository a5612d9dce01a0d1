"""Overlap cross-batch flush work with the main batch loop.

Profiling the 3.1 Gbp repeat-genome bench (SOAP3DP_TIMERS=1) showed a
steady batch takes ~1s while every rescue flush adds a ~4s batch whose
wall time is almost entirely device waits (A2.fetch 2.4s, dp.align
1.0s, half_rescue 1.7s wall vs 0.9s cpu per 4-batch window) — the main
thread sits idle on D2H fetches while nothing else dispatches. The
reference overlaps its equivalent host stages with the next batch's
GPU kernels via dedicated pthreads (alignment.cu:554-561, 1005-1027).

AsyncFlusher is that overlap for the RescueQueue / SalvageQueue /
Phase2 flushes: drain() runs on the main thread (queue state is
main-thread-only), the phase work runs on ONE worker thread, and the
main loop keeps dispatching. Requires a thread-safe writer
(io.aio.AsyncWriter serializes producers with a lock; its single
consumer thread owns the underlying file writer). JAX dispatch is
thread-safe; the two threads' device work interleaves on the
device, which is exactly the point — the flush's D2H waits no
longer serialize the pipeline.

Memory stays bounded: at most one flush runs while one more waits;
submit() blocks beyond that.
"""

from __future__ import annotations

import threading
from typing import Callable


class AsyncFlusher:
    """Run `queue.flush_items(queue.drain(), writer)` on a worker thread.

    ``queue`` must provide drain() -> items, flush_items(items, writer)
    -> summary, should_flush() and .pending. Summaries accumulate and
    are returned by join(). ``on_flush(queued_n, summary)`` (optional)
    runs on the worker after each flush — for per-flush logging.
    """

    def __init__(self, queue, writer, on_flush: Callable | None = None,
                 eager_min: int = 2048):
        import concurrent.futures

        self.queue = queue
        self.writer = writer
        self.on_flush = on_flush
        self.eager_min = eager_min
        self._ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="soap3dp-flush")
        self._futs: list = []
        self._lock = threading.Lock()

    def maybe_submit(self) -> None:
        """Submit when the queue's own threshold fires — or eagerly
        when the worker is IDLE and at least ``eager_min`` items wait.
        Eager drains keep the end-of-run backlog (which cannot overlap
        anything) near one batch's worth instead of up to the full
        flush threshold — targeting the 9.7s final-batch drain the
        3.1 Gbp bench showed with threshold-only flushing. The idle
        gate bounds flush count by batch count, so per-flush fixed
        costs stay amortized."""
        if self.queue.should_flush():
            self.submit()
        elif (self.queue.pending >= self.eager_min
              and all(f.done() for f in self._futs)):
            self.submit()

    def submit(self) -> None:
        """Drain the queue now and flush it on the worker."""
        self._reap(max_inflight=2)  # bound queued payload memory
        qn = self.queue.pending
        items = self.queue.drain()
        if not items:
            return
        self._futs.append(self._ex.submit(self._run, items, qn))

    def _run(self, items, qn: int):
        s = self.queue.flush_items(items, self.writer)
        if self.on_flush is not None:
            self.on_flush(qn, s)
        return s

    def _reap(self, max_inflight: int) -> None:
        import concurrent.futures as cf

        while len([f for f in self._futs if not f.done()]) >= max_inflight:
            cf.wait(self._futs, return_when=cf.FIRST_COMPLETED)

    def join(self, summary_add) -> None:
        """Wait for all flushes; fold their summaries via
        ``summary_add(s)``. Re-raises the first worker failure."""
        futs, self._futs = self._futs, []
        for f in futs:
            summary_add(f.result())
        self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # on error paths just stop the worker; callers join() on success
        self._ex.shutdown(wait=False, cancel_futures=True)
