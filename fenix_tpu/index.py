"""Materialized cell-assignment index + search entry point.

API parity: /root/reference/src/fenix/io/index/index.py — ``make``
assigns every source row to its nearest composite cell and writes
``<root>/indexes/<source>/<column>/<name>.arrow`` with a single
``__CODED_ID__:int64`` column (index.py:37-65); ``load`` joins it onto
the source table (index.py:19-34); ``call`` is the query engine
(index.py:81-170), here delegated to fenix_tpu.engine.executor.

Accelerator-first: assignment is per-codebook argmin on device in large blocks
(sum-separable, O(N·n·k·d)) — the reference scores all k^n composite
cells per row (coder.py:171-181) even though the argmin factorizes.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Iterator, Sequence

import jax.numpy as jnp
import numpy as np
import pyarrow as pa

from fenix_tpu import coder as coder_mod
from fenix_tpu import expr as expr_mod
from fenix_tpu.engine import executor
from fenix_tpu.engine.executor import CODE_COL, DIST_COL, QUERY_COL  # re-export
from fenix_tpu.io import arrow, ingest, table
from fenix_tpu.ops import cells as cells_ops

LOCATION: str = "indexes"

__all__ = [
    "CODE_COL", "DIST_COL", "QUERY_COL", "call", "delete_rows", "drop",
    "drop_all", "drop_for_source", "extend_for_source",
    "indexes_for_source", "list", "load", "make", "path_of",
]

ASSIGN_BLOCK: int = 1 << 16  # rows per device assignment batch


def path_of(root: str, name: str, source: str, column: str) -> str:
    return table.safe_join(root, LOCATION, source, column, name + ".arrow")


def load(root: str, name: str, source: str | Sequence[str], column: str) -> pa.Table:
    if isinstance(source, str):
        return table.join(
            table.load(root, source),
            arrow.load(path_of(root, name, source, column)),
            axis=1,
        )
    assert isinstance(source, Sequence)
    return table.join(*[load(root, name, s, column) for s in source])


def make(root: str, name: str, source: str | Sequence[str], column: str) -> pa.Table:
    if not isinstance(source, str):
        assert isinstance(source, Sequence)
        return table.join(*[make(root, name, s, column) for s in source])

    from fenix_tpu.io.locks import catalog_lock

    with catalog_lock(root):
        data = table.load(root, source)
        codes = _assign_codes(root, name, data.column(column))
        _write_codes(path_of(root, name, source, column), codes)
        return load(root, name, source, column)


def _assign_codes(root: str, name: str, column: pa.ChunkedArray) -> np.ndarray:
    """Nearest-composite-cell id per row, block-wise on device.

    Blocks stream through :func:`fenix_tpu.io.batch.prefetch_to_device`
    so block i+1's host→device transfer (and its host-side dtype copy)
    overlaps block i's assignment compute — the reference DataLoader-
    pool role (SURVEY §2.3 last row) on the one ingest path that is a
    genuine upload/compute pipeline.

    HOST-RESIDENT tables (the engine/residency.py regime: the fp32
    corpus doesn't fit the HBM budget) assign on the HOST instead —
    the whole oversized lifecycle (make-index, probed search, nomax
    reads) then never moves the corpus over the link. ``FENIX_ASSIGN``
    = host|device overrides the routing either way."""
    from fenix_tpu.io import batch as batch_mod
    from fenix_tpu.utils import hbm
    from fenix_tpu.utils.metrics import GLOBAL as metrics

    coding = coder_mod.load(root, name)
    metric = coding["config"]["metric"]

    matrix = ingest.fixed_size_list_to_numpy(column)
    num_rows = matrix.shape[0]

    route = os.environ.get("FENIX_ASSIGN", "auto").lower()
    if route not in ("auto", "host", "device"):
        raise ValueError(f"FENIX_ASSIGN must be auto|host|device, got {route!r}")
    if route == "auto":
        budget = hbm.budget_bytes()
        # ~ the router's dual-residency test (fp32 + 16 B/row aux)
        route = (
            "host"
            if budget is not None
            and matrix.shape[0] * (4 * matrix.shape[1] + 16) > 0.9 * budget
            else "device"
        )

    if route == "host":
        metrics.add("index.host_assigns")
        codes = np.empty(num_rows, dtype=np.int64)
        chunk = max(1, (256 << 20) // max(4 * matrix.shape[1], 1))
        for start in range(0, num_rows, chunk):
            stop = min(start + chunk, num_rows)
            codes[start:stop] = cells_ops.assign_cells_np(
                np.asarray(matrix[start:stop], dtype=np.float32),
                coding["tensor"],
                metric,
            )
        return codes

    codebooks = jnp.asarray(coding["tensor"])

    def blocks() -> Iterator[np.ndarray]:
        for start in range(0, num_rows, ASSIGN_BLOCK):
            yield np.asarray(matrix[start : start + ASSIGN_BLOCK], dtype=np.float32)

    codes = np.empty(num_rows, dtype=np.int64)
    start = 0
    for block in batch_mod.prefetch_to_device(blocks()):
        stop = start + block.shape[0]
        codes[start:stop] = np.asarray(
            cells_ops.assign_cells(block, codebooks, metric=metric), dtype=np.int64
        )
        start = stop
    return codes


def _write_codes(path: str, codes: np.ndarray) -> None:
    schema = pa.schema({CODE_COL: pa.int64()})
    arrow.make(
        path,
        pa.RecordBatchReader.from_batches(
            schema,
            iter([pa.record_batch([pa.array(codes)], names=[CODE_COL])]),
        ),
    )


def list(root: str) -> Iterator[str]:
    base = os.path.join(root, LOCATION)
    for path in sorted(glob.glob(os.path.join(base, "**", "*.arrow"), recursive=True)):
        yield os.path.relpath(path, base).removesuffix(".arrow")


def drop(root: str, name: str, source: str, column: str) -> None:
    path = path_of(root, name, source, column)
    if os.path.exists(path):
        os.unlink(path)


def indexes_for_source(root: str, source: str) -> Iterator[tuple[str, str]]:
    """Yield ``(name, column)`` for every index built over ``source``.

    Index files live at ``indexes/<source>/<column>/<name>.arrow``; under
    the given source's directory the first path component is the column
    and the remainder is the coder name (which, like sources, may contain
    ``/`` for namespacing — columns may not).

    Sources nest (``a`` and ``a/b`` can both exist), so a path under
    ``indexes/a/`` may belong to the sibling source ``a/b`` instead. An
    entry is attributed to ``source`` only if its parsed column is in the
    source's schema AND its parsed name has a coder artifact — a nested
    sibling's files fail both, so mutations on ``a`` never touch
    ``a/b``'s indexes.
    """
    base = table.safe_join(root, LOCATION, source)
    try:
        columns = set(table.load(root, source).schema.names)
    except FileNotFoundError:
        return
    for path in sorted(glob.glob(os.path.join(base, "**", "*.arrow"), recursive=True)):
        rel = os.path.relpath(path, base)
        column, _, name = rel.partition(os.sep)
        name = name.removesuffix(".arrow")
        if column in columns and os.path.exists(coder_mod.path_of(root, name)):
            yield name, column


def drop_for_source(root: str, source: str) -> None:
    """Drop every index file over ``source`` (its assignments are no
    longer row-aligned once the table is overwritten).

    Deliberately broader than :func:`indexes_for_source`, which
    attributes files via the CURRENT schema: an overwrite that removes a
    column would strand that column's index files, and a later table
    re-adding the column could resurrect the stale, misaligned index.
    So remove EVERY file under the source's index dir that does not
    belong to a nested sibling source (``a/b`` keeps its files when
    ``a`` is dropped)."""
    base = table.safe_join(root, LOCATION, source)
    siblings = [
        other[len(source) + 1 :] + "/"
        for other in table.list(root)
        if other != source and other.startswith(source + "/")
    ]
    for path in glob.glob(
        os.path.join(glob.escape(base), "**", "*.arrow"), recursive=True
    ):
        rel = os.path.relpath(path, base).replace(os.sep, "/")
        if any(rel.startswith(prefix) for prefix in siblings):
            continue
        os.unlink(path)


def extend_for_source(root: str, source: str, new_rows: pa.Table) -> None:
    """Append cell assignments for freshly appended ``new_rows`` to every
    index over ``source`` — only the new rows are scored (the existing
    assignment is immutable), keeping ingest cost O(rows appended).
    Serializes on the catalog lock (read-modify-write per index file)."""
    from fenix_tpu.io.locks import catalog_lock

    with catalog_lock(root):
        for name, column in [*indexes_for_source(root, source)]:
            path = path_of(root, name, source, column)
            old = ingest.scalar_column_to_numpy(arrow.load(path).column(CODE_COL))
            new = _assign_codes(root, name, new_rows.column(column))
            _write_codes(path, np.concatenate([old.astype(np.int64), new]))


def delete_rows(root: str, source: str, filter: expr_mod.Expr) -> int:
    """Delete the rows of ``source`` matching ``filter``.

    The ``__CODED_ID__`` index files are row-aligned with the source, so
    every index over it is filtered by the SAME keep-mask — assignments
    for surviving rows are reused verbatim, no re-scoring. Both rewrites
    go through the atomic publish in :func:`fenix_tpu.io.arrow.make` and
    serialize on the catalog lock. Readers that land between the table
    and index publishes (or after a crash in the window) hit a
    row-count mismatch, which the device cache resolves by resyncing
    the index (engine/session ``_resync_index``).
    """
    from fenix_tpu.io.locks import catalog_lock

    with catalog_lock(root):
        data = table.load(root, source)
        delete = np.asarray(filter.mask(data), dtype=bool)
        keep = pa.array(~delete)

        indexes = [*indexes_for_source(root, source)]
        for name, column in indexes:
            idx_path = path_of(root, name, source, column)
            idx = arrow.load(idx_path)
            if idx.num_rows != data.num_rows:
                raise RuntimeError(
                    f"index {name!r} over {source!r}/{column!r} has "
                    f"{idx.num_rows} rows but the table has {data.num_rows}; "
                    "re-run sync_index before deleting"
                )

        old_stamp = table.stamp(root, source)
        table.rewrite(root, source, data.filter(keep).to_reader())
        for name, column in indexes:
            idx_path = path_of(root, name, source, column)
            arrow.make(idx_path, arrow.load(idx_path).filter(keep).to_reader())
        # keep-mask lineage: device caches at the old revision compact
        # their HBM buffers in place instead of re-streaming the corpus
        table.record_lineage(
            root, source, old_stamp, table.stamp(root, source), ~delete
        )
        return int(delete.sum())


def upsert_rows(
    root: str, source: str, data: pa.Table, key: str = "id"
) -> tuple[int, int]:
    """Replace-or-insert by ``key``: delete existing rows whose key
    appears in ``data``, then append ``data`` — ONE catalog-lock scope,
    so concurrent readers see either the old or the new revision of
    every key and indexes stay consistent throughout (deletion filters
    them by the row mask; the append scores only the new rows).
    Returns ``(replaced, inserted)``: keys that existed and were
    replaced vs net-new keys. Rows duplicated WITHIN ``data`` are
    appended as-is — deduplication is the caller's contract.
    """
    from fenix_tpu.io.locks import catalog_lock

    with catalog_lock(root):
        path = table.path_of(root, source)
        replaced = 0
        if os.path.exists(path):
            keys = data.column(key).to_pylist()
            replaced = delete_rows(root, source, expr_mod.field(key).isin(keys))
            table.append(root, source, data)
            extend_for_source(root, source, data)
        else:
            table.append(root, source, data)
            drop_for_source(root, source)  # orphans of a dropped table
        return replaced, data.num_rows - replaced


def drop_all(root: str, name: str) -> None:
    """Drop every index built from coder ``name`` (fixes the reference's
    unreachable path-parse in flight.py:95-100).

    The coder name must match a whole path suffix at a ``/`` boundary —
    a bare ``endswith(name + ".arrow")`` would also delete indexes of
    any coder whose name merely ends with the same string."""
    base = os.path.join(root, LOCATION)
    suffix = os.sep + name + ".arrow"
    for path in glob.glob(os.path.join(base, "**", "*.arrow"), recursive=True):
        if path.endswith(suffix):
            os.unlink(path)


def call(
    root: str,
    coding: str | None,
    source: str | Sequence[str],
    column: str,
    target: Any,
    metric: str | None = None,
    select: Sequence[str] | None = None,
    filter: expr_mod.Expr | None = None,
    maxval: int | None = None,
    probes: int | None = None,
) -> pa.Table:
    """Filtered exact/ANN kNN search (reference index.py:81-170)."""
    cache = executor.get_cache(root)
    req = executor.SearchRequest(
        source=source,
        column=column,
        target=target,
        metric=metric,
        coding=coding,
        select=select,
        filter=filter,
        maxval=maxval,
        probes=probes,
    )
    return executor.execute_search(cache, req)
