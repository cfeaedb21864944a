"""Work-conserving search micro-batching.

Every device dispatch pays a fixed host-side cost, so N concurrent
single-query searches issued individually serialize into
N × (overhead + scan). This module coalesces them: a
per-root dispatcher thread drains every queued *compatible* request at
once and runs them as ONE device call
(fenix_tpu.engine.executor.execute_search_batched). When the server is
idle a lone request is dispatched immediately — batching adds no
latency; under load batches form exactly as fast as the device drains
them.

Compatibility (executor.batchable/batch_key): same (source, column,
metric, precision, coding+probes, filter) — mixed-predicate workloads
coalesce into one dispatch per distinct predicate. Only no-top-k reads
run solo on the caller's thread.

The reference has no analog (one request = one full torch pass,
reference flight.py:62-77); this is the accelerator-side answer to its
implicit thread-pool concurrency.
"""

from __future__ import annotations

import threading
from collections import deque

import pyarrow as pa

from fenix_tpu.engine import executor
from fenix_tpu.engine.session import DeviceCache
from fenix_tpu.io import ingest

# Upper bound on coalesced queries per dispatch — keeps the jit shape
# within the canonical Q steps and bounds rescore gather staging.
MAX_BATCH_QUERIES = 4096


class _Item:
    __slots__ = ("req", "queries", "key", "result", "error", "done", "inflight")

    def __init__(self, req: executor.SearchRequest, queries: int, key: tuple) -> None:
        self.req = req
        self.queries = queries
        self.key = key
        self.result: pa.Table | None = None
        self.error: BaseException | None = None
        self.done = threading.Event()
        self.inflight = False


class SearchBatcher:
    """Queue + two-stage pipeline (dispatch / completion) for one
    root's DeviceCache.

    The dispatcher coalesces queued requests and launches the device
    work. With ``FENIX_PIPELINE_DEPTH > 0`` a separate completion
    thread blocks on each batch's device→host fetch so batch i+1's
    upload/compute can overlap batch i's readback. The default is
    synchronous completion, chosen on the previous accelerator's remote
    link; the overlap is unmeasured on the H100 (ROADMAP S2)."""

    def __init__(self, cache: DeviceCache, max_queries: int = MAX_BATCH_QUERIES) -> None:
        import os
        import queue as queue_mod

        self.cache = cache
        self.max_queries = max_queries
        self._queue: deque[_Item] = deque()
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self.pipeline_depth = int(os.environ.get("FENIX_PIPELINE_DEPTH", "0"))
        # (group, finish) pairs in flight; bounded for backpressure
        self._inflight: queue_mod.Queue = queue_mod.Queue(
            maxsize=max(self.pipeline_depth, 1)
        )
        self._completer: threading.Thread | None = None

    # -- public -----------------------------------------------------------

    def submit(self, req: executor.SearchRequest) -> pa.Table:
        if not executor.batchable(req):
            return executor.execute_search(self.cache, req)

        try:
            column = self.cache.host_table(req.source).schema.field(req.column)
            dim = ingest.vector_type(column.type).list_size
        except Exception:
            # missing table/column: fail on the caller's thread
            return executor.execute_search(self.cache, req)
        queries = _query_count(req.target, dim)
        if queries is None or queries > self.max_queries // 2:
            return executor.execute_search(self.cache, req)
        try:
            # key derivation validates the metric; a bad request must
            # fail on the caller's thread, not poison the dispatcher
            key = executor.batch_key(req)
        except Exception:
            return executor.execute_search(self.cache, req)

        item = _Item(req, queries, key)
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="fenix-search-batcher", daemon=True
                )
                self._thread.start()
            if self.pipeline_depth > 0 and (
                self._completer is None or not self._completer.is_alive()
            ):
                self._completer = threading.Thread(
                    target=self._complete, name="fenix-search-completer", daemon=True
                )
                self._completer.start()
            self._queue.append(item)
            self._cv.notify()
        item.done.wait()
        if item.error is not None:
            raise item.error
        assert item.result is not None
        return item.result

    # -- dispatcher ---------------------------------------------------------

    def _drain(self) -> list[_Item]:
        """Take everything queued (bounded), waiting if empty."""
        with self._cv:
            while not self._queue:
                self._cv.wait()
            items: list[_Item] = []
            total = 0
            while self._queue and total + self._queue[0].queries <= self.max_queries:
                item = self._queue.popleft()
                items.append(item)
                total += item.queries
            return items

    def _run(self) -> None:
        while True:
            items = self._drain()
            try:
                groups: dict[tuple, list[_Item]] = {}
                for item in items:
                    groups.setdefault(item.key, []).append(item)
                for group in groups.values():
                    self._dispatch(group)
            except BaseException:  # noqa: BLE001 — dispatcher must not die
                pass
            finally:
                # never hang a waiter: anything neither dispatched (in
                # flight) nor resolved gets an error now
                for item in items:
                    if not item.done.is_set() and not item.inflight:
                        if item.error is None and item.result is None:
                            item.error = RuntimeError("batch dispatcher error")
                        item.done.set()

    def _dispatch(self, group: list[_Item]) -> None:
        from fenix_tpu.utils.metrics import GLOBAL

        GLOBAL.add("batch.dispatches")
        GLOBAL.add("batch.requests", len(group))
        GLOBAL.add("batch.queries", sum(item.queries for item in group))
        try:
            finish = executor.execute_search_batched(
                self.cache, [item.req for item in group], defer=True
            )
        except BaseException as exc:  # noqa: BLE001 — delivered to callers
            self._fallback_solo(group, exc)
            return
        if self.pipeline_depth <= 0:
            self._finish_group(group, finish)
            return
        for item in group:
            item.inflight = True
        self._inflight.put((group, finish))  # bounded: backpressure

    def _complete(self) -> None:
        while True:
            group, finish = self._inflight.get()
            self._finish_group(group, finish)

    def _finish_group(self, group: list[_Item], finish) -> None:
        try:
            results = finish()
            for item, result in zip(group, results):
                item.result = result
            for item in group:
                item.done.set()
        except BaseException as exc:  # noqa: BLE001
            self._fallback_solo(group, exc)

    def _fallback_solo(self, group: list[_Item], exc: BaseException) -> None:
        """Deliver a failed batch: a poisoned group (e.g. one bad target
        dim) must not fail innocent neighbors — retry each solo."""
        if len(group) > 1:
            for item in group:
                try:
                    item.result = executor.execute_search(self.cache, item.req)
                except BaseException as solo_exc:  # noqa: BLE001
                    item.error = solo_exc
        else:
            group[0].error = exc
        for item in group:
            item.done.set()


def _query_count(target, dim: int) -> int | None:
    """Number of queries in a target (flat arrays hold Q·dim scalars,
    matching executor.normalize_target), or None if unknown (solo)."""
    import numpy as np

    if isinstance(target, pa.Table) or isinstance(target, pa.ChunkedArray):
        return len(target)
    if isinstance(target, pa.Array):
        if pa.types.is_fixed_size_list(target.type):
            return len(target)
        return len(target) // dim if len(target) % dim == 0 else None
    try:
        arr = np.asarray(target)
    except Exception:
        return None
    if arr.ndim == 1:
        return int(arr.size) // dim if arr.size % dim == 0 else None
    if arr.ndim == 2:
        return int(arr.shape[0])
    return None


_BATCHERS: dict[int, SearchBatcher] = {}
_BATCHERS_LOCK = threading.Lock()


def get_batcher(cache: DeviceCache) -> SearchBatcher:
    key = id(cache)
    with _BATCHERS_LOCK:
        batcher = _BATCHERS.get(key)
        if batcher is None or batcher.cache is not cache:
            batcher = SearchBatcher(cache)
            _BATCHERS[key] = batcher
        return batcher
