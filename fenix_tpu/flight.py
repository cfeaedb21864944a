"""Arrow Flight serving surface: Server + client SDK.

Verb parity: /root/reference/src/fenix/flight.py — ``do_put`` ingests a
table (flight.py:34-44), ``do_get`` reads (optionally coded/filtered/
projected) tables (flight.py:46-60), ``do_exchange`` runs kNN search
(flight.py:62-77), ``do_action`` is the control plane (flight.py:79-134).
Client methods mirror flight.py:137-292: make_table / read_table /
drop_table / make_index / sync_index / drop_index / search / remove.

Redesigned by intent (SURVEY.md §2.2):
- **No pickle.** Commands, tickets, and action bodies are JSON; filters
  are fenix_tpu.expr trees (declarative, safe).
- **No server session state.** Every request carries its own
  parameters; the reference's set-/del- attribute races cannot occur.
  The set-*/del-* action verbs are therefore gone.
- ``drop-index`` actually drops the index files (the reference's path
  parse never matched, flight.py:95-100).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Iterator, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.flight as fl

from fenix_tpu import coder as coder_mod
from fenix_tpu import expr as expr_mod
from fenix_tpu import index as index_mod
from fenix_tpu.engine import executor, service
from fenix_tpu.io import ingest, table
from fenix_tpu.utils import replay
from fenix_tpu.utils.faults import GLOBAL as FAULTS
from fenix_tpu.utils.metrics import GLOBAL as METRICS

LOGGER = logging.getLogger("fenix_tpu")

METRICS_SET: set[str] = {"cosine", "dot", "inner_product", "l2", "euclidean"}


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def _loads(raw: bytes) -> Any:
    return json.loads(raw.decode())


def _decode_filter(obj: Any) -> expr_mod.Expr | None:
    return None if obj is None else expr_mod.Expr.from_dict(obj)


class Server(fl.FlightServerBase):
    """Stateless Flight front-end over the device query engine."""

    def __init__(self, root: str, host: str = "0.0.0.0", port: int = 9001) -> None:
        self.root = os.path.abspath(root)
        self.grpc = f"grpc://{host}:{port}"
        super().__init__(location=self.grpc)

    @property
    def cache(self) -> Any:
        return executor.get_cache(self.root)

    # -- ingest (reference flight.py:34-44) -------------------------------

    def do_put(
        self,
        ctx: fl.ServerCallContext,
        descriptor: fl.FlightDescriptor,
        reader: fl.MetadataRecordBatchReader,
        writer: fl.FlightMetadataWriter,
    ) -> None:
        FAULTS.check("put")
        name = descriptor.path[0].decode()
        mode = descriptor.path[1].decode() if len(descriptor.path) > 1 else "overwrite"
        with METRICS.timed("put", table=name, mode=mode):
            from fenix_tpu.io.locks import catalog_lock
            from fenix_tpu.parallel import distributed

            if mode != "overwrite" and distributed.load_manifest(self.root, name):
                raise ValueError(
                    f"table {name!r} is repartitioned; append/upsert are not "
                    "supported on a sharded name — overwrite it or re-ingest"
                )

            match mode:
                case "overwrite":
                    # One lock scope: a concurrent append landing between
                    # the rewrite and the index drop would extend the old
                    # (row-misaligned) index over the new base — and when
                    # old/new row counts coincide the count-based
                    # self-heal never triggers.
                    with catalog_lock(self.root):
                        # a fresh table replaces any previous sharded form
                        distributed.drop_repartition(self.root, name)
                        table.make(self.root, name, reader.to_reader())
                        # Any existing index is no longer row-aligned;
                        # drop it so probed search fails loudly instead of
                        # returning rows assigned under the previous table
                        # revision (the reference leaves them stale,
                        # SURVEY.md §2.2.3).
                        index_mod.drop_for_source(self.root, name)
                case "append":
                    new = reader.to_reader().read_all()
                    # One lock scope: table append + index extension form
                    # a single catalog mutation (an interleaved append
                    # would otherwise extend indexes twice off one base).
                    with catalog_lock(self.root):
                        fresh = not os.path.exists(table.path_of(self.root, name))
                        table.append(self.root, name, new)
                        if fresh:
                            # a dropped-then-recreated table must not
                            # inherit leftover index files
                            index_mod.drop_for_source(self.root, name)
                        else:
                            # Score ONLY the appended rows into every
                            # index — incremental ingest, O(rows appended).
                            index_mod.extend_for_source(self.root, name, new)
                case "upsert":
                    key = (
                        descriptor.path[2].decode()
                        if len(descriptor.path) > 2
                        else "id"
                    )
                    new = reader.to_reader().read_all()
                    replaced, inserted = index_mod.upsert_rows(
                        self.root, name, new, key=key
                    )
                    writer.write(
                        pa.py_buffer(
                            _dumps({"replaced": replaced, "inserted": inserted})
                        )
                    )
                case _:
                    raise ValueError(f"unknown put mode {mode!r}")

    # -- table read (reference flight.py:46-60, stateless) ----------------

    def do_get(self, ctx: fl.ServerCallContext, ticket: fl.Ticket):
        FAULTS.check("get")
        req = _loads(ticket.ticket)
        source = req["source"]
        coding = req.get("coding")
        column = req.get("column")
        select = req.get("select")
        filter_ = _decode_filter(req.get("filter"))
        order_by = req.get("order_by")  # [[column, "ascending"|"descending"], ...]

        from fenix_tpu.parallel import distributed

        source = distributed.resolve_source(self.root, source)
        with METRICS.timed("get", source=source):
            if coding is not None and column is not None:
                data = index_mod.load(self.root, coding, source, column)
            else:
                data = table.load(self.root, source)

            if filter_ is not None:
                data = data.filter(pa.array(filter_.mask(data)))

            if order_by:
                import pyarrow.compute as pc

                data = data.take(
                    pc.sort_indices(data, sort_keys=[(c, d) for c, d in order_by])
                )

            if select is not None:
                data = data.select(select)

            return fl.GeneratorStream(data.schema, data.to_reader())

    # -- search (reference flight.py:62-77) -------------------------------

    def do_exchange(
        self,
        ctx: fl.ServerCallContext,
        descriptor: fl.FlightDescriptor,
        reader: fl.MetadataRecordBatchReader,
        writer: fl.MetadataRecordBatchWriter,
    ) -> None:
        FAULTS.check("search")
        config = _loads(descriptor.command)
        target_table = reader.read_all()
        target = target_table.column("target").combine_chunks()

        from fenix_tpu.utils import profiling

        # per-request device trace behind $FENIX_TRACE_DIR (no-op when
        # unset; concurrent handlers during an active capture run
        # untraced — profiling._TRACE_LOCK)
        with profiling.trace(), profiling.annotate("fenix.rpc.search"), METRICS.timed(
            "search", source=config["source"], metric=config.get("metric")
        ) as record:
            data = service.run_search_config(self.cache, config, target)
            record["rows_returned"] = data.num_rows
            # flat value column = one query (reference wire shape);
            # FixedSizeList column = one query per row
            record["queries"] = (
                len(target) if pa.types.is_fixed_size_list(target.type) else 1
            )
            record["maxval"] = config.get("maxval")
            record["probes"] = config.get("probes")
            record["precision"] = config.get("precision") or "fp32"

        replay.record(config, target_table, data)

        writer.begin(data.schema)
        writer.write_table(data)

    # -- control plane (reference flight.py:79-134) -----------------------

    def do_action(self, ctx: fl.ServerCallContext, action: fl.Action) -> Iterator[fl.Result]:
        body = action.body.to_pybytes()
        config = _loads(body) if body else {}

        match action.type:
            case "make-coder":
                from fenix_tpu.parallel import distributed

                config["source"] = distributed.resolve_source(
                    self.root, config["source"]
                )
                with METRICS.timed("make-coder", coder=config.get("name")):
                    coder_mod.make(self.root, **config)
                return iter([])

            case "make-index":
                from fenix_tpu.parallel import distributed

                config["source"] = distributed.resolve_source(
                    self.root, config["source"]
                )
                with METRICS.timed("make-index", coder=config.get("name")):
                    index_mod.make(self.root, **config)
                self.cache.invalidate()
                return iter([])

            case "drop-table":
                from fenix_tpu.parallel import distributed

                # a repartitioned name drops its shard tables + manifest
                if not distributed.drop_repartition(self.root, config["name"]):
                    # indexes first: attribution needs the table's
                    # schema, and a dropped table must not strand index
                    # files that a later same-named table would inherit
                    index_mod.drop_for_source(self.root, config["name"])
                    table.drop(self.root, **config)
                self.cache.invalidate()
                return iter([])

            case "repartition":
                from fenix_tpu.parallel import distributed

                name = config["source"]
                num_shards = int(
                    config.get("num_shards")
                    or (self.cache.mesh.devices.size if self.cache.mesh else 2)
                )
                with METRICS.timed("repartition", table=name, shards=num_shards):
                    manifest = distributed.repartition(
                        self.root,
                        name,
                        num_shards,
                        key_column=config.get("key", "id"),
                        mesh=self.cache.mesh,
                    )
                self.cache.invalidate()
                return iter([fl.Result(manifest.to_json().encode())])

            case "drop-index":
                coder_mod.drop(self.root, config["name"])
                index_mod.drop_all(self.root, config["name"])
                self.cache.invalidate()
                return iter([])

            case "compact-table":
                # fold delta parts into the base Arrow IPC file (the
                # reference-readable at-rest form) — e.g. before backing
                # up or handing the root to another reader
                with METRICS.timed("compact", table=config["name"]):
                    table.compact(self.root, config["name"])
                return iter([])

            case "delete-rows":
                from fenix_tpu.parallel import distributed

                sources = distributed.resolve_source(self.root, config["source"])
                if isinstance(sources, str):
                    sources = [sources]
                with METRICS.timed("delete-rows", source=config["source"]):
                    # per-shard deletes: each shard's mask-aligned
                    # filter is independent, so the resolved list sums
                    deleted = sum(
                        index_mod.delete_rows(
                            self.root, s, _decode_filter(config["filter"])
                        )
                        for s in sources
                    )
                return iter([fl.Result(_dumps({"deleted": deleted}))])

            case "remove":
                shutil.rmtree(self.root, ignore_errors=True)
                self.cache.invalidate()
                return iter([])

            case "list-tables":
                return iter([fl.Result(_dumps([*table.list(self.root)]))])

            case "list-coders":
                return iter([fl.Result(_dumps([*coder_mod.list(self.root)]))])

            case "list-indexes":
                return iter([fl.Result(_dumps([*index_mod.list(self.root)]))])

            case "stats":
                snap = METRICS.snapshot()
                snap["cache.incremental_refreshes"] = float(
                    self.cache.incremental_refreshes
                )
                snap["cache.lineage_refreshes"] = float(
                    self.cache.lineage_refreshes
                )
                snap["cache.device_bytes"] = float(self.cache.device_bytes())
                snap["cache.evictions"] = float(self.cache.evictions)
                return iter([fl.Result(_dumps(snap))])

            case "health":
                return iter([fl.Result(b'{"status":"ok"}')])

            case "fault-inject":
                # arm deterministic failure points — resilience testing
                # only, and only when the operator opted in (any client
                # could otherwise deny service with one request)
                if os.environ.get("FENIX_ENABLE_FAULT_INJECTION") != "1":
                    raise PermissionError(
                        "fault injection disabled; set "
                        "FENIX_ENABLE_FAULT_INJECTION=1 on the server"
                    )
                FAULTS.configure(config.get("spec", ""))
                return iter([])

            case _:
                raise ValueError(f"unknown action {action.type!r}")

    # The reference leaves these unimplemented (flight.py:24-32);
    # here they expose the catalog through the standard Flight APIs.

    def _flight_info(self, name: str) -> fl.FlightInfo:
        data = table.load(self.root, name)
        return fl.FlightInfo(
            data.schema,
            fl.FlightDescriptor.for_path(name),
            [fl.FlightEndpoint(_dumps({"source": name}), [])],
            data.num_rows,
            -1,
        )

    def get_flight_info(
        self, ctx: fl.ServerCallContext, descriptor: fl.FlightDescriptor
    ) -> fl.FlightInfo:
        name = descriptor.path[0].decode()
        return self._flight_info(name)

    def list_flights(self, ctx: fl.ServerCallContext, criteria: bytes):
        for name in table.list(self.root):
            yield self._flight_info(name)


class Flight:
    """Client SDK (reference flight.py:137-292 method parity).

    ``retries`` > 0 re-issues **idempotent** requests (search, reads,
    admin queries) on transient server failures with exponential
    backoff — paired with the server's fault-injection points for
    resilience testing.
    """

    def __init__(
        self, host: str = "0.0.0.0", port: int = 9001, retries: int = 0
    ) -> None:
        self.host = host
        self.port = port
        self.retries = retries
        self._conn: fl.FlightClient | None = None

    def _retrying(self, fn):
        import time as _time

        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except fl.FlightError as e:  # noqa: PERF203
                last = e
                if attempt < self.retries:
                    _time.sleep(0.05 * (2**attempt))
        assert last is not None
        raise last

    @property
    def conn(self) -> fl.FlightClient:
        if self._conn is None:
            self._conn = fl.connect(f"grpc://{self.host}:{self.port}")
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    # -- tables -----------------------------------------------------------

    def make_table(self, name: str, data: pa.RecordBatchReader) -> "Flight":
        return self._put(name, data, "overwrite")

    def append_table(self, name: str, data: pa.RecordBatchReader) -> "Flight":
        """Append rows to ``name`` (created if absent). Existing indexes
        over the table are extended incrementally — only the appended
        rows are scored."""
        return self._put(name, data, "append")

    def _put(self, name: str, data: pa.RecordBatchReader, mode: str) -> "Flight":
        descriptor = fl.FlightDescriptor.for_path(name, mode)
        writer, _ = self.conn.do_put(descriptor, data.schema)
        with writer:
            for batch in data:
                writer.write_batch(batch)
        return self

    def upsert_rows(
        self, name: str, data: pa.RecordBatchReader, key: str = "id"
    ) -> dict:
        """Replace-or-insert by ``key`` (created if the table is
        absent): rows whose key matches an incoming row are deleted,
        then the incoming rows append — atomically with respect to
        other catalog mutations, with indexes kept consistent. Returns
        ``{"replaced": n, "inserted": m}``. Not retried (the counts are
        not idempotent)."""
        descriptor = fl.FlightDescriptor.for_path(name, "upsert", key)
        writer, meta_reader = self.conn.do_put(descriptor, data.schema)
        with writer:
            for batch in data:
                writer.write_batch(batch)
            writer.done_writing()
            buf = meta_reader.read()
        return _loads(buf.to_pybytes()) if buf is not None else {}

    def delete_rows(self, source: str, filter: expr_mod.Expr) -> int:
        """Delete rows matching ``filter``; returns the count removed.
        Indexes over the table stay consistent (filtered by the same
        row mask).

        Deliberately NOT retried: the verb's effect is idempotent but
        its return value is not — a retry after a lost response would
        report 0 for rows the first attempt already deleted."""
        if not isinstance(filter, expr_mod.Expr):
            raise TypeError("filter must be a fenix_tpu.expr.Expr")
        action = fl.Action(
            "delete-rows", _dumps({"source": source, "filter": filter.to_dict()})
        )
        results = [*self.conn.do_action(action)]
        return _loads(results[0].body.to_pybytes())["deleted"]

    def read_table(
        self,
        source: str | Sequence[str],
        coding: str | None = None,
        column: str | None = None,
        select: Sequence[str] | None = None,
        filter: expr_mod.Expr | None = None,
        order_by: Sequence[tuple[str, str]] | None = None,
    ) -> pa.RecordBatchReader:
        if filter is not None and not isinstance(filter, expr_mod.Expr):
            raise TypeError(
                "filter must be a fenix_tpu.expr.Expr "
                "(e.g. expr.field('id') < 10) — arbitrary pyarrow "
                "expressions are not accepted on the wire"
            )
        ticket = fl.Ticket(
            _dumps(
                {
                    "source": source if isinstance(source, str) else [*source],
                    "coding": coding,
                    "column": column,
                    "select": [*select] if select is not None else None,
                    "filter": filter.to_dict() if filter is not None else None,
                    "order_by": (
                        [[c, d] for c, d in order_by] if order_by is not None else None
                    ),
                }
            )
        )
        return self._retrying(lambda: self.conn.do_get(ticket).to_reader())

    def drop_table(self, name: str) -> "Flight":
        self._action("drop-table", {"name": name})
        return self

    def compact_table(self, name: str) -> "Flight":
        """Fold any pending append delta parts into the table's base
        Arrow IPC file (idempotent; the at-rest form the reference can
        read directly)."""
        self._action("compact-table", {"name": name})
        return self

    def repartition(
        self, source: str, num_shards: int | None = None, key: str = "id"
    ) -> dict:
        """Hash-partition ``source`` into ``num_shards`` shard tables
        (default: the server's mesh size) keyed by ``key``. The name
        then resolves to the shard list on every search/read; existing
        indexes are dropped (row-misaligned) — re-run make_index after.
        Returns the shard manifest."""
        results = self._action(
            "repartition", {"source": source, "num_shards": num_shards, "key": key}
        )
        return _loads(results[0].body.to_pybytes())

    # -- index lifecycle --------------------------------------------------

    def make_index(
        self,
        name: str,
        source: str | Sequence[str],
        column: str,
        config: coder_mod.Config,
    ) -> "Flight":
        self._action(
            "make-coder",
            {"name": name, "source": source, "column": column, "config": dict(config)},
        )
        return self.sync_index(name, source, column)

    def sync_index(self, name: str, source: str | Sequence[str], column: str) -> "Flight":
        self._action("make-index", {"name": name, "source": source, "column": column})
        return self

    def drop_index(self, name: str) -> "Flight":
        self._action("drop-index", {"name": name})
        return self

    # -- search -----------------------------------------------------------

    def search(
        self,
        target: Any,
        source: str | Sequence[str],
        column: str,
        metric: str,
        coding: str | None = None,
        select: Sequence[str] | None = None,
        filter: expr_mod.Expr | None = None,
        maxval: int | None = None,
        probes: int | None = None,
        join: dict | None = None,
        aggregate: dict | None = None,
        precision: str = "fp32",
        residency: str = "auto",
        extra: dict | None = None,
    ) -> pa.Table:
        assert metric in METRICS_SET, f"metric must be one of {sorted(METRICS_SET)}"
        assert precision in ("fp32", "bf16", "int8"), precision
        assert residency in ("auto", "dual", "int8", "stream"), residency
        assert extra is None or isinstance(extra, dict), extra
        if filter is not None and not isinstance(filter, expr_mod.Expr):
            raise TypeError("filter must be a fenix_tpu.expr.Expr")

        descriptor = fl.FlightDescriptor.for_command(
            _dumps(
                {
                    "coding": coding,
                    "source": source if isinstance(source, str) else [*source],
                    "column": column,
                    "metric": metric,
                    "select": [*select] if select is not None else None,
                    "filter": filter.to_dict() if filter is not None else None,
                    "maxval": maxval,
                    "probes": probes,
                    "join": join,
                    "aggregate": aggregate,
                    "precision": precision,
                    "residency": residency,
                    # per-request knobs (e.g. {"window": ...} widens the
                    # int8-resident/streaming rescore window)
                    "extra": extra or {},
                }
            )
        )

        target = self._encode_target(target)

        def attempt() -> pa.Table:
            writer, reader = self.conn.do_exchange(descriptor)
            with writer:
                writer.begin(target.schema)
                writer.write_table(target)
                writer.done_writing()
                return reader.read_all()

        return self._retrying(attempt)

    @staticmethod
    def _encode_target(target: Any) -> pa.Table:
        """Single query → flat float column (reference flight.py:273-279
        wire shape); query batch [Q, D] → FixedSizeList column."""
        if hasattr(target, "__array__") and not isinstance(target, (pa.Array, pa.ChunkedArray)):
            target = np.asarray(target)
        if isinstance(target, np.ndarray):
            if target.ndim == 2:
                target = ingest.numpy_to_fixed_size_list(
                    np.ascontiguousarray(target, dtype=np.float32), pa.float32()
                )
            else:
                target = pa.array(np.ascontiguousarray(target))
        return pa.table({"target": target})

    # -- admin ------------------------------------------------------------

    def remove(self) -> "Flight":
        self._action("remove", {})
        return self

    def list_tables(self) -> list[str]:
        return self._action_json("list-tables")

    def list_coders(self) -> list[str]:
        return self._action_json("list-coders")

    def list_indexes(self) -> list[str]:
        return self._action_json("list-indexes")

    def stats(self) -> dict[str, float]:
        return self._action_json("stats")

    def health(self) -> dict[str, str]:
        return self._action_json("health")

    def _action(self, verb: str, body: Any) -> list[fl.Result]:
        # Drain the result iterator: pyarrow executes the action lazily
        # and server-side errors only surface on consumption. Admin
        # verbs are idempotent → retried like reads.
        return self._retrying(
            lambda: [*self.conn.do_action(fl.Action(verb, _dumps(body)))]
        )

    def _action_json(self, verb: str) -> Any:
        results = self._action(verb, {})
        return _loads(results[0].body.to_pybytes())
