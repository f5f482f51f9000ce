"""Request coalescing + semaphore-bounded batch dispatch (asyncio); a copy
of ``repro.serve.batcher`` but for :meth:`CoalescingBatcher.drain`, which
the reference's loops forever once a dispatch has finished before it.

The serving-side idiom: individual lookups arriving within a short
window are coalesced into one deduplicated batch, batches dispatch
under a concurrency semaphore, and every caller's future resolves with
its own row. One batched gather per window amortizes the per-call
overhead exactly the way one batched device step amortizes launch
overhead on the write path.

Timeline of one window (``coalesce_ms = 2``)::

    t=0.0  submit(a) ──┐ opens the window, starts the flush timer
    t=0.4  submit(b) ──┤ joins the pending batch
    t=0.9  submit(a) ──┤ dedup: shares a's future
    t=2.0  timer fires ─┴─► dispatch({a, b}) under the semaphore
                            → both a-waiters + the b-waiter resolve

A burst that reaches ``max_batch`` before the timer flushes
immediately — the window bounds latency, the batch cap bounds memory.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Hashable, Sequence

_STATS_WINDOW = 65_536   # most recent request latencies / batch sizes kept


@dataclass(frozen=True)
class ServeConfig:
    """Serving-tier knobs.

    ``coalesce_ms``      — how long the first request of a window waits
                           for company before its batch dispatches;
    ``max_batch``        — flush immediately at this many distinct keys;
    ``max_concurrency``  — concurrent in-flight batch dispatches;
    ``cache_rows``       — hot-row LRU capacity (0 disables);
    ``dispatch_in_thread`` — run the gather in a worker thread
                           (``asyncio.to_thread``) so a large gather
                           never blocks the event loop; leave off for
                           micro-batches where the hop costs more than
                           the gather.
    """

    coalesce_ms: float = 2.0
    max_batch: int = 256
    max_concurrency: int = 4
    cache_rows: int = 4096
    dispatch_in_thread: bool = False


class CoalescingBatcher:
    """Coalesces single-key lookups into deduplicated batch dispatches.

    Args:
        dispatch: ``(keys) -> {key: value}`` — the batched lookup. Runs
            on the event loop (or a worker thread, see
            ``ServeConfig.dispatch_in_thread``); must return a value
            for every requested key.
        cfg: the :class:`ServeConfig` window/batch/concurrency knobs.

    Invariants: a key has at most one pending future at a time
    (concurrent submits of the same key share it); every submitted key
    is dispatched exactly once per window it is pending in; dispatch
    failures reject all of that batch's futures with the same error.
    """

    def __init__(self, dispatch: Callable[[Sequence[Hashable]], dict],
                 cfg: ServeConfig = ServeConfig()):
        self._dispatch = dispatch
        self.cfg = cfg
        self._pending: dict[Hashable, tuple[asyncio.Future, float]] = {}
        self._timer: asyncio.Task | None = None
        self._sem = asyncio.Semaphore(cfg.max_concurrency)
        self._inflight: set[asyncio.Task] = set()
        # telemetry (bounded windows)
        self._latencies_s: deque[float] = deque(maxlen=_STATS_WINDOW)
        self._batch_sizes: deque[int] = deque(maxlen=_STATS_WINDOW)
        self.requests = 0
        self.dispatches = 0
        self._max_concurrent_seen = 0
        self._now_concurrent = 0

    async def submit(self, key: Hashable):
        """Look up one key; resolves when its coalesced batch does."""
        self.requests += 1
        entry = self._pending.get(key)
        if entry is None:
            fut = asyncio.get_running_loop().create_future()
            self._pending[key] = (fut, time.perf_counter())
            if len(self._pending) >= self.cfg.max_batch:
                self._flush()
            elif self._timer is None or self._timer.done():
                self._timer = asyncio.create_task(self._flush_after_window())
        else:
            fut = entry[0]
        return await fut

    async def _flush_after_window(self) -> None:
        await asyncio.sleep(self.cfg.coalesce_ms / 1000.0)
        self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, {}
        timer, cur = self._timer, asyncio.current_task()
        if timer is not None and timer is not cur and not timer.done():
            timer.cancel()
        self._timer = None
        task = asyncio.create_task(self._run_batch(batch))
        # keep a strong ref until done (create_task refs are weak)
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _run_batch(self, batch: dict) -> None:
        keys = list(batch)
        async with self._sem:
            self._now_concurrent += 1
            self._max_concurrent_seen = max(self._max_concurrent_seen,
                                            self._now_concurrent)
            try:
                if self.cfg.dispatch_in_thread:
                    results = await asyncio.to_thread(self._dispatch, keys)
                else:
                    results = self._dispatch(keys)
            except Exception as e:          # reject the whole batch
                for fut, _ in batch.values():
                    if not fut.done():
                        fut.set_exception(e)
                return
            finally:
                self._now_concurrent -= 1
        done = time.perf_counter()
        self.dispatches += 1
        self._batch_sizes.append(len(keys))
        for key, (fut, t0) in batch.items():
            self._latencies_s.append(done - t0)
            if not fut.done():
                fut.set_result(results[key])

    async def drain(self) -> None:
        """Flush anything pending and wait for in-flight dispatches.

        Waits on the tasks not yet done, not on the set's emptiness: a
        finished task leaves the set only when the loop runs its done
        callback, and since Python 3.12 ``gather`` over finished tasks
        completes without yielding to the loop, so a loop on emptiness
        would spin forever."""
        self._flush()
        while pending := [t for t in self._inflight if not t.done()]:
            await asyncio.gather(*pending, return_exceptions=True)

    def stats(self) -> dict:
        """Latency percentiles (per request, submit→resolve), coalesced
        batch sizes, and dispatch counters — over the most recent
        telemetry window."""
        lat = sorted(self._latencies_s)
        sizes = self._batch_sizes

        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {
            "requests": self.requests,
            "dispatches": self.dispatches,
            "p50_ms": pct(0.50) * 1e3,
            "p99_ms": pct(0.99) * 1e3,
            "mean_batch": (sum(sizes) / len(sizes)) if sizes else 0.0,
            "max_batch": max(sizes) if sizes else 0,
            "max_concurrent_dispatches": self._max_concurrent_seen,
        }
