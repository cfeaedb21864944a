"""Search query executor: descriptor → fused device computation → Arrow.

Implements the semantics of /root/reference/src/fenix/io/index/index.py:81-170
(normalize target → optional IVF probe pruning → filter → distance →
select → ascending top-k) as one device pass: predicate and probe masks
are pushed below the blocked distance matmul (fenix_tpu.ops.distance),
and only the winning row ids + distances return to the host, where the
result rows are gathered from the memory-mapped Arrow table.

Divergence (documented): when top-k applies, results are always sorted
ascending by distance with ties broken by row id — the reference's
``select_k_unstable`` order is unspecified for ties, and when the
filtered candidate count is ≤ maxval the reference skips sorting
entirely; deterministic output is required for exact-match parity
testing (BASELINE.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import jax.numpy as jnp
import numpy as np
import pyarrow as pa


import jax

from fenix_tpu import expr as expr_mod
from fenix_tpu.engine.session import DeviceCache
from fenix_tpu.io import ingest
from fenix_tpu.ops import cells as cells_ops
from fenix_tpu.ops import distance as distance_ops
from fenix_tpu.ops import topk2
from fenix_tpu.utils.metrics import GLOBAL as METRICS

CODE_COL: str = "__CODED_ID__"
DIST_COL: str = "__DISTANCE__"
QUERY_COL: str = "__QUERY_ID__"

# Canonical query-batch sizes (jit cache keys are shapes).
_Q_STEPS = (1, 8, 64, 256, 1024)

# Above this composite-cell count the clustered layout's O(n_cells)
# offset table is not worth building (high-cardinality codings use the
# bounded-beam ranking and the masked-scan kernel instead).
_CLUSTERED_MAX_CELLS = 1 << 22


def _canonical_q(q: int) -> int:
    for step in _Q_STEPS:
        if q <= step:
            return step
    return -(-q // 1024) * 1024


def _canonical_k(k: int) -> int:
    p = 1
    while p < k:
        p <<= 1
    return p


@jax.jit
def _overlay_mask(aux_add, mask):
    """Fold a per-request row mask into the cached aux_add."""
    return jnp.where(mask, aux_add, distance_ops.NEG_INF)


@jax.jit
def _take_rows(x, perm):
    return jnp.take(x, perm, axis=0)


import functools


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _search_packed(
    corpus, queries, aux_mul, aux_add, k, metric, corpus_scan=None, corpus_scan_int8=None
):
    """Two-phase search returning one packed [2,Q,k] array — a single
    device→host roundtrip for (distances, ids)."""
    d, i = topk2.topk_two_phase(
        corpus,
        queries,
        aux_mul,
        aux_add,
        k=k,
        metric=metric,
        corpus_scan=corpus_scan,
        corpus_scan_int8=corpus_scan_int8,
    )
    return topk2.pack_result(d, i)


def _rank_cells(queries, coding_data, metric: str, probes: int) -> np.ndarray:
    """Top-``probes`` composite cells per query as a HOST array, with
    the bounded beam fallback when k^n exceeds dense enumeration
    (mirrors coder.call). Dense grids rank on the host — fetching a
    device-ranked [Q, P] costs a device round trip per request."""
    from fenix_tpu.utils import profiling

    codebooks = coding_data["tensor"]
    n_books, k_book, _ = codebooks.shape
    probes = int(min(probes, k_book**n_books))
    with profiling.annotate("fenix.rank_cells"):
        if k_book**n_books > cells_ops.DENSE_CELL_LIMIT:
            return np.asarray(
                cells_ops.topk_cells_bounded(
                    queries, jnp.asarray(codebooks), metric, probes
                )
            )
        return cells_ops.topk_cells_np(np.asarray(queries), codebooks, metric, probes)


@functools.lru_cache(maxsize=None)
def _sharded_fn(mesh, k: int, metric: str, precision: str, probed: bool):
    """Compiled mesh-sharded search step (fenix_tpu.parallel.search),
    memoized per (mesh, canonical shape/mode) — each build is a fresh
    shard_map jit and compiles are expensive in this environment."""
    from fenix_tpu.parallel import search as psearch

    return psearch.build_serving_search(
        mesh, k=k, metric=metric, probed=probed, precision=precision
    )


def _sharded_mask(mesh, mask_np: np.ndarray):
    from fenix_tpu.parallel.mesh import row_sharding

    return jax.device_put(mask_np, row_sharding(mesh, 1))


@functools.lru_cache(maxsize=None)
def _sharded_ivf_fn(mesh, k: int, metric: str):
    from fenix_tpu.parallel import search as psearch

    return psearch.build_serving_ivf_clustered(mesh, k=k, metric=metric)


@functools.lru_cache(maxsize=None)
def _sharded_window_fn(mesh, k: int, w: int, metric: str):
    """Compiled sharded phase-A window kernel for the mesh-composed
    int8-resident / int8-streaming residency modes."""
    from fenix_tpu.parallel import search as psearch

    return psearch.build_serving_window_int8(mesh, k=k, w=w, metric=metric)


@functools.lru_cache(maxsize=None)
def _ring_fn(mesh, k: int, metric: str, precision: str = "fp32", probed: bool = False):
    from fenix_tpu.parallel import search as psearch

    return psearch.build_ring_search(
        mesh, k=k, metric=metric, precision=precision, probed=probed
    )


def _ring_threshold() -> "int | None":
    """Minimum q_pad for the ring (exchange-overlapped) route.
    FENIX_RING=off disables; FENIX_RING=<n> overrides (tests force the
    route at tiny Q with it)."""
    import os

    env = os.environ.get("FENIX_RING", "auto").lower()
    if env in ("off", "0", "none"):
        return None
    return 512 if env == "auto" else max(1, int(env))


def _mesh_exact_packed(
    cache, source, column: str, metric: str, precision: str,
    queries, q_pad: int, k_pad: int, plan: "_FilterPlan", corpus,
):
    """Mesh-sharded exact (non-probed) dispatch shared by the solo and
    batched paths. Large fp32 query batches route to the ring search
    (query blocks rotate over the interconnect, exchange overlapped
    with the local scan); everything else takes the replicated-queries
    scan with the candidate-only all_gather merge."""
    import jax as _jax

    from fenix_tpu.parallel.mesh import row_sharding

    mesh = cache.mesh
    aux_mul, aux_add = cache.sharded_aux(source, column, metric)
    aux_add = plan.overlay(aux_add, "sharded")

    scan_args: tuple = ()
    if precision == "bf16":
        scan_args = (cache.matrix_bf16(source, column, sharded=True).data,)
    elif precision == "int8":
        v8, sv = cache.matrix_int8(source, column, sharded=True)
        scan_args = (v8.data, sv.data)

    threshold = _ring_threshold()
    n_shards = int(mesh.devices.size)
    if threshold is not None and q_pad >= threshold:
        # Q pads up to the next shard multiple (zero queries — row-
        # independent, sliced back off) instead of falling back; the
        # ring runs over the flattened (data, model) index, so any
        # mesh shape and any scan precision rides it (VERDICT r2 #4).
        ring_q = -(-q_pad // n_shards) * n_shards
        q_run = queries
        if ring_q != q_pad:
            q_run = jnp.concatenate(
                [queries, jnp.zeros((ring_q - q_pad, queries.shape[1]), queries.dtype)]
            )
        q_sharded = _jax.device_put(q_run, row_sharding(mesh, 2))
        packed = _ring_fn(mesh, k_pad, metric, precision)(
            corpus.data, q_sharded, aux_mul, aux_add, *scan_args
        )
        return packed[:, :q_pad] if ring_q != q_pad else packed

    return _sharded_fn(mesh, k_pad, metric, precision, False)(
        corpus.data, queries, aux_mul, aux_add, *scan_args,
    )


class _StaleRevision(Exception):
    """A concurrent catalog mutation landed mid-request: the device
    layouts read along the way span table revisions. Retried."""


class _FilterPlan:
    """Per-request filter handling (SURVEY §7 "filter pushdown below
    the matmul").

    Device pushdown: when the predicate is device-evaluable
    (expr.device_evaluable — bool/int/f32 columns, exactly-representable
    literals), the row mask is computed ON DEVICE from HBM-resident
    scalar columns and memoized per (predicate, revision) — zero
    per-query host→device mask bytes. Host fallback (string predicates,
    float64 columns, int64 beyond int32): the [N_pad] bool mask uploads
    per request as before. Every layout the kernels scan in ("flat",
    "sharded", "clustered", "sharded_clustered") folds the mask into
    the cached aux_add; length mismatches mean the mask and layout span
    table revisions → _StaleRevision retry."""

    def __init__(self, cache, source, column, filt, data, n_pad: int, rows: int):
        self.cache = cache
        self.source = source
        self.column = column
        self.filt = filt
        self.data = data
        self.n_pad = n_pad
        self.rows = rows
        self._host: np.ndarray | None = None
        self.pushdown = filt is not None and filt.device_evaluable(data.schema)

    @property
    def active(self) -> bool:
        return self.filt is not None

    def host_mask(self) -> np.ndarray:
        """``[n_pad]`` bool mask via Arrow kernels (padding rows False)."""
        if self._host is None:
            from fenix_tpu.utils import profiling

            with profiling.annotate("fenix.mask_build"):
                m = np.zeros(self.n_pad, dtype=bool)
                m[: self.rows] = self.filt.mask(self.data)
                self._host = m
        return self._host

    def overlay(self, aux_add, layout: str, coding: str | None = None):
        if not self.active:
            return aux_add
        length = int(aux_add.shape[0])
        sharded = layout in ("sharded", "sharded_clustered")

        if self.pushdown:
            mask = self.cache.device_filter_mask(
                self.source, self.filt, sharded=sharded
            )
            if mask is not None:
                if mask.shape[0] != length:
                    raise _StaleRevision
                if layout == "clustered":
                    perm = self.cache.clustered_perm(coding, self.source, self.column)
                    if perm.shape[0] != length:
                        raise _StaleRevision
                    mask = _take_rows(mask, perm)
                elif layout == "sharded_clustered":
                    from fenix_tpu.parallel import search as psearch

                    perm = self.cache.sharded_clustered_perm(
                        coding, self.source, self.column
                    )
                    if perm.shape[0] != length:
                        raise _StaleRevision
                    mask = psearch.permute_rows_sharded(self.cache.mesh, mask, perm)
                METRICS.add("filter.device_pushdown")
                return _overlay_mask(aux_add, mask)

        METRICS.add("filter.host_upload")
        m = self.host_mask()
        if layout == "flat":
            if m.shape[0] != length:
                raise _StaleRevision
            return _overlay_mask(aux_add, jnp.asarray(m))
        if layout == "sharded":
            if m.shape[0] != length:
                raise _StaleRevision
            return _overlay_mask(aux_add, _sharded_mask(self.cache.mesh, m))
        if layout == "clustered":
            perm, _ = self.cache.clustered_meta(coding, self.source, self.column)
            if m.shape[0] != perm.shape[0] or perm.shape[0] != length:
                raise _StaleRevision
            return _overlay_mask(aux_add, jnp.asarray(m[perm]))
        assert layout == "sharded_clustered", layout
        perm_local, _, _ = self.cache.sharded_clustered_meta(
            coding, self.source, self.column
        )
        if m.shape[0] != perm_local.shape[0] or perm_local.shape[0] != length:
            raise _StaleRevision
        per = perm_local.shape[0] // int(self.cache.mesh.devices.size)
        perm_global = (np.arange(perm_local.shape[0]) // per) * per + perm_local
        return _overlay_mask(aux_add, _sharded_mask(self.cache.mesh, m[perm_global]))


def _check_revision(cache, source, column: str, coding, snap_stamp: tuple) -> None:
    """Raise _StaleRevision when a catalog mutation landed after the
    snapshot: the device entries fetched for this dispatch (aux, scan
    copies, coded ids, clustered layouts) memoize under their OWN
    stamps, so a mid-request mutation could pair a newer entry with the
    snapshot's host table. Checking the revision AFTER assembling the
    inputs proves they all saw the snapshot's files."""
    if cache.snapshot_stamp(source, column, coding) != snap_stamp:
        raise _StaleRevision


def _clustered_eligible(coding_data) -> bool:
    """Whether the coding's cell count permits a clustered offset table
    (single router rule for the solo/batched, mesh/single paths)."""
    n_books, k_book, _ = coding_data["tensor"].shape
    return int(k_book) ** int(n_books) <= _CLUSTERED_MAX_CELLS


def _mesh_probed_packed(
    cache, coding: str, source, column: str, coding_data, queries, cells,
    q_pad: int, k_pad: int, metric: str, plan: "_FilterPlan",
    precision: str = "fp32",
):
    """Mesh-sharded probed dispatch shared by the solo and batched
    paths. Preferred route: PER-SHARD clustered layouts — every shard
    gathers only its own probed buckets (cost ∝ locally-probed rows)
    and the kernel's original-global-id candidates merge over ICI; the
    gather rescores fp32-exactly, so ``precision`` has nothing to
    quantize there. Work-based fallback to the masked local scan
    (which DOES honor the bf16/int8 scan copies), mirroring the
    single-device router."""
    mesh = cache.mesh
    n_shards = int(mesh.devices.size)
    use_clustered = _clustered_eligible(coding_data)
    bucket_stack = None
    if use_clustered:
        perm_local, offsets, _ = cache.sharded_clustered_meta(coding, source, column)
        n_pad_s = perm_local.shape[0]
        per = n_pad_s // n_shards
        bucket = topk2.bucket_for(q_pad, per)
        per_shard = [
            _ivf_bucket_lists(cells, offsets[s], bucket, per // bucket)
            for s in range(n_shards)
        ]
        width = max(b.shape[1] for b in per_shard)
        bucket_stack = np.stack(
            [
                np.pad(b, ((0, 0), (0, width - b.shape[1])), constant_values=-1)
                for b in per_shard
            ]
        )
        # route on PER-SHARD work: gathering more than ~one local
        # corpus pass loses to the masked scan
        use_clustered = q_pad * width * bucket <= per

    if use_clustered:
        corpus_s, coded_s, orig_ids = cache.sharded_clustered(coding, source, column)
        aux_mul_s, aux_add_s = cache.sharded_clustered_aux(
            coding, source, column, metric
        )
        aux_add_s = plan.overlay(aux_add_s, "sharded_clustered", coding)
        return _sharded_ivf_fn(mesh, k_pad, metric)(
            corpus_s.data, queries, aux_mul_s, aux_add_s,
            coded_s.data, orig_ids.data, cells, jnp.asarray(bucket_stack),
        )

    coded = cache.coded_ids(coding, source, column, sharded=True)
    aux_mul, aux_add = cache.sharded_aux(source, column, metric)
    aux_add = plan.overlay(aux_add, "sharded")
    corpus_sh = cache.sharded_matrix(source, column)
    scan = _scan_copies(cache, source, column, precision, sharded=True)
    scan_args = scan.get("corpus_scan_int8", ())
    if "corpus_scan" in scan:
        scan_args = (scan["corpus_scan"],)

    threshold = _ring_threshold()
    if threshold is not None and q_pad >= threshold:
        import jax as _jax

        from fenix_tpu.parallel.mesh import row_sharding

        # probed masked-scan ring: each block's probe cells rotate
        # alongside its queries (pad cells with −1 — matches no cell)
        ring_q = -(-q_pad // n_shards) * n_shards
        q_run, cells_run = queries, cells
        if ring_q != q_pad:
            q_run = jnp.concatenate(
                [queries, jnp.zeros((ring_q - q_pad, queries.shape[1]), queries.dtype)]
            )
            cells_run = jnp.concatenate(
                [cells, jnp.full((ring_q - q_pad, cells.shape[1]), -1, cells.dtype)]
            )
        q_sharded = _jax.device_put(q_run, row_sharding(mesh, 2))
        cells_sharded = _jax.device_put(cells_run, row_sharding(mesh, 2))
        packed = _ring_fn(mesh, k_pad, metric, precision, probed=True)(
            corpus_sh.data, q_sharded, aux_mul, aux_add, *scan_args,
            coded.data, cells_sharded,
        )
        return packed[:, :q_pad] if ring_q != q_pad else packed

    return _sharded_fn(mesh, k_pad, metric, precision, True)(
        corpus_sh.data, queries, aux_mul, aux_add, *scan_args, coded.data, cells,
    )


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _search_probed_packed(
    corpus, queries, aux_mul, aux_add, coded, cells, k, metric,
    corpus_scan=None, corpus_scan_int8=None,
):
    d, i = topk2.topk_two_phase_probed(
        corpus, queries, aux_mul, aux_add, coded, cells, k=k, metric=metric,
        corpus_scan=corpus_scan, corpus_scan_int8=corpus_scan_int8,
    )
    return topk2.pack_result(d, i)


def _scan_copies(cache, source, column: str, precision: str, *, sharded: bool) -> dict:
    """kwargs holding the low-precision phase-1 scan copy for the
    requested precision (empty for fp32)."""
    if precision == "bf16":
        return {"corpus_scan": cache.matrix_bf16(source, column, sharded=sharded).data}
    if precision == "int8":
        v8, sv = cache.matrix_int8(source, column, sharded=sharded)
        return {"corpus_scan_int8": (v8.data, sv.data)}
    return {}


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _search_ivf_packed(
    corpus_s, queries, aux_mul_s, aux_add_s, coded_s, orig_ids_s, cells,
    bucket_lists, k, metric,
):
    d, i = topk2.topk_ivf_clustered(
        corpus_s, queries, aux_mul_s, aux_add_s, coded_s, orig_ids_s, cells,
        bucket_lists, k=k, metric=metric,
    )
    return topk2.pack_result(d, i)


def _ivf_bucket_lists(
    cells_np: np.ndarray, offsets: np.ndarray, bucket: int, n_buckets: int
) -> np.ndarray:
    """Bucket indices covering each query's probed cells in the
    clustered layout ([Q, B] int32, −1 padded; B a power of two so the
    jit cache stays small). Fully vectorized — a per-query Python loop
    cost ~100 ms at Q=256."""
    q, p = cells_np.shape
    sentinel = np.iinfo(np.int64).max
    ok = (cells_np >= 0) & (cells_np < len(offsets) - 1)
    cs = np.where(ok, cells_np, 0)
    starts = np.where(ok, offsets[cs] // bucket, 0)
    ends = np.where(ok, -(-offsets[cs + 1] // bucket), 0)  # ceil
    widths = np.maximum(ends - starts, 0)  # [Q, P]
    m = int(widths.max(initial=0))
    if m == 0:
        return np.full((q, 8), -1, np.int32)

    # [Q, P, M] candidate grid, invalid slots → sentinel
    grid = starts[:, :, None] + np.arange(m)[None, None, :]
    grid = np.where(
        (np.arange(m)[None, None, :] < widths[:, :, None]) & (grid < n_buckets),
        grid,
        sentinel,
    ).reshape(q, p * m)
    grid.sort(axis=1)
    # dedupe within each row: repeats → sentinel, then re-sort compacts
    dup = np.zeros_like(grid, dtype=bool)
    dup[:, 1:] = grid[:, 1:] == grid[:, :-1]
    grid = np.where(dup | (grid == sentinel), sentinel, grid)
    grid.sort(axis=1)

    counts = (grid != sentinel).sum(axis=1)
    width = int(counts.max(initial=1)) or 1
    b = 1 << (width - 1).bit_length()
    b = min(max(b, 8), max(n_buckets, 1))
    out = grid[:, :b].astype(np.int64)
    out[out == sentinel] = -1
    # rows whose count exceeded b cannot happen (b >= width by
    # construction unless clamped by n_buckets, which bounds counts too)
    return out.astype(np.int32)


_CACHES: dict[str, DeviceCache] = {}


def get_cache(root: str) -> DeviceCache:
    import os

    root = os.path.abspath(root)
    if root not in _CACHES:
        _CACHES[root] = DeviceCache(root)
    return _CACHES[root]


@dataclass
class SearchRequest:
    """Stateless, wire-safe search descriptor (fixes the reference's
    server-session mutation, flight.py:105-131 / SURVEY §2.2.1)."""

    source: str | Sequence[str]
    column: str
    target: np.ndarray  # [Q, D] fp32
    metric: str | None = None
    coding: str | None = None
    select: Sequence[str] | None = None
    filter: expr_mod.Expr | None = None
    maxval: int | None = None
    probes: int | None = None
    # "fp32" = exact; "bf16" / "int8" = half-/quarter-traffic phase-1
    # scan with exact fp32 rescore of candidates (recall ≈ 1, not
    # guaranteed).
    precision: str = "fp32"
    # "auto" = best residency mode that fits the HBM budget; "dual" /
    # "int8" / "stream" force one (engine/residency.py): int8 keeps only
    # the int8 copy in HBM and rescores exactly on the host; stream
    # scans corpora larger than HBM in double-buffered chunks.
    residency: str = "auto"
    extra: dict[str, Any] = field(default_factory=dict)


def normalize_target(target: Any, dim: int) -> np.ndarray:
    """Accept ndarray / jax.Array / Arrow fixed-size-list / flat arrays;
    return ``[Q, dim]`` fp32 (reference index.py:101-111 normalization,
    extended to multi-query)."""
    if isinstance(target, pa.Table):
        target = target.column("target")
    if isinstance(target, pa.ChunkedArray):
        target = target.combine_chunks()
    if isinstance(target, pa.Array):
        if pa.types.is_fixed_size_list(target.type) or isinstance(
            target, pa.ExtensionArray
        ):
            # extension targets (TensorArray/quint8) view through their
            # storage — quint8 dequantizes, matching column semantics
            target = ingest.fixed_size_list_to_numpy(target)
        else:
            # Flat value column of Q·dim scalars (the reference client
            # sends a single query this way, flight.py:273-279).
            target = target.to_numpy(zero_copy_only=False)
    if isinstance(target, pa.FixedSizeListScalar):
        target = np.asarray(target.values)

    target = np.asarray(target, dtype=np.float32)
    if target.ndim == 1:
        assert target.size % dim == 0, (target.size, dim)
        target = target.reshape(-1, dim)
    assert target.ndim == 2 and target.shape[1] == dim, (target.shape, dim)
    return target


def execute_search(cache: DeviceCache, req: SearchRequest) -> pa.Table:
    """Run a search request against device-resident columns, retrying
    when a concurrent catalog mutation lands mid-request (the coding
    paths read snapshot + clustered meta/layout/aux under independent
    mtime stamps; _StaleRevision marks a detected cross-revision mix)."""
    for _ in range(4):
        try:
            return _execute_search_once(cache, req)
        except _StaleRevision:
            continue
    raise RuntimeError(f"table {req.source!r} kept changing during search")


def _execute_search_once(cache: DeviceCache, req: SearchRequest) -> pa.Table:
    # --- residency routing: corpora past the HBM budget serve through
    # the host-corpus modes (int8-resident / streaming) BEFORE any
    # device fp32 residency is built (engine/residency.py) -----------------
    from fenix_tpu.engine import residency

    mode = residency.plan(cache, req)
    if mode != residency.DUAL:
        return residency.execute_solo(cache, req, mode)

    # --- host-side table (for result gather and schema parity),
    # snapshot-consistent with the device-resident matrix -----------------
    data, corpus, snap_stamp = cache.snapshot(req.source, req.column, coding=req.coding)

    column_type = ingest.vector_type(data.schema.field(req.column).type)
    value_dtype = column_type.value_type.to_pandas_dtype()
    dim = column_type.list_size
    target = normalize_target(req.target, dim)
    num_queries = target.shape[0]

    metric = req.metric
    coding_data = cache.coding(req.coding) if (req.coding and req.probes) else None
    if coding_data is not None and metric is None:
        # reference index.py:116-117: default to the coder's metric
        metric = coding_data["config"]["metric"]
    assert metric is not None, "metric is required when no coder supplies one"
    metric = distance_ops.canonical_metric(metric)

    n_pad, rows = corpus.rows_padded, corpus.rows
    views = cache.host_column_views(req.source, data, snap_stamp, req.coding)

    # Filter plan: device pushdown when the predicate is device-
    # evaluable (no per-query mask transfer), host mask fallback
    # otherwise. The cached aux already masks padding rows.
    plan = _FilterPlan(cache, req.source, req.column, req.filter, data, n_pad, rows)

    queries = jnp.asarray(target)

    # --- select list (reference index.py:128-129) ------------------------
    select = [*req.select] if req.select is not None else data.column_names
    select = select + [DIST_COL]

    # --- no-top-k path: distance column over all selected rows ----------
    if req.maxval is None:
        return _execute_nomax(
            cache, req, data, corpus, plan, coding_data, metric,
            target, value_dtype, select, snap_stamp, views,
        )

    # --- top-k path ------------------------------------------------------
    # Canonicalized shapes (Q padded up, k rounded to a power of two)
    # bound the jit-compile surface — compiles are expensive and
    # per-process in this environment (no cross-process kernel cache).
    k = int(min(req.maxval, rows))
    q_pad = _canonical_q(num_queries)
    k_pad = min(_canonical_k(k), n_pad)
    if q_pad != num_queries:
        queries = jnp.concatenate(
            [queries, jnp.zeros((q_pad - num_queries, queries.shape[1]), queries.dtype)]
        )

    if coding_data is not None:
        # IVF-clustered route: gather only the probed cells' buckets
        # (the masked-scan kernel costs a full corpus pass regardless
        # of selectivity; fenix_tpu.ops.topk2.topk_ivf_clustered).
        # Routing happens BEFORE any device-side layout is built. Only
        # REAL queries rank cells (dense ranking is O(k^n) per row);
        # padding queries get −1 probes, which never match a cell id.
        cells = _rank_cells(target, coding_data, metric, int(req.probes))
        if q_pad != num_queries:
            cells = np.concatenate(
                [cells, np.full((q_pad - num_queries, cells.shape[1]), -1, cells.dtype)]
            )

        if cache.mesh is not None:
            packed = _mesh_probed_packed(
                cache, req.coding, req.source, req.column, coding_data,
                queries, cells, q_pad, k_pad, metric, plan, req.precision,
            )
            _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
            dists, ids = topk2.unpack_result(packed)
            return gather_results(
                data, select, dists[:num_queries, :k], ids[:num_queries, :k], value_dtype,
                views=views,
            )

        use_clustered = _clustered_eligible(coding_data)
        bucket_lists = None
        if use_clustered:
            perm, offsets = cache.clustered_meta(req.coding, req.source, req.column)
            if plan.active and perm.shape[0] != n_pad:
                raise _StaleRevision  # snapshot and layout span revisions
            bucket = topk2.bucket_for(q_pad, n_pad)
            bucket_lists = _ivf_bucket_lists(cells, offsets, bucket, n_pad // bucket)
            # Route on total work: the clustered gather moves
            # Q·B·bucket rows in scattered chunks, the masked scan reads
            # the corpus once regardless of Q. Gathering more than ~one
            # corpus pass loses (302 vs 34 ms at Q=256, probes=64/4096).
            use_clustered = q_pad * bucket_lists.shape[1] * bucket <= n_pad

        if not use_clustered:
            coded = cache.coded_ids(req.coding, req.source, req.column)
            aux_mul, aux_add = cache.metric_aux(req.source, req.column, metric)
            aux_add = plan.overlay(aux_add, "flat")
            packed = _search_probed_packed(
                corpus.data, queries, aux_mul, aux_add, coded.data, cells,
                k=k_pad, metric=metric,
                **_scan_copies(cache, req.source, req.column, req.precision, sharded=False),
            )
            _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
            dists, ids = topk2.unpack_result(packed)
            return gather_results(
                data, select, dists[:num_queries, :k], ids[:num_queries, :k], value_dtype,
                views=views,
            )

        corpus_s, coded_s, orig_ids = cache.clustered(req.coding, req.source, req.column)
        aux_mul_s, aux_add_s = cache.clustered_aux(
            req.coding, req.source, req.column, metric
        )
        aux_add_s = plan.overlay(aux_add_s, "clustered", req.coding)
        packed = _search_ivf_packed(
            corpus_s.data,
            queries,
            aux_mul_s,
            aux_add_s,
            coded_s.data,
            orig_ids.data,
            cells,
            jnp.asarray(bucket_lists),
            k=k_pad,
            metric=metric,
        )
        _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
        # kernel returns ORIGINAL ids already ordered by (dist, id)
        dists, ids = topk2.unpack_result(packed)
        return gather_results(
            data, select, dists[:num_queries, :k], ids[:num_queries, :k],
            value_dtype, views=views,
        )
    elif cache.mesh is not None:
        # Mesh-sharded exact scan: every shard runs the two-phase kernel
        # over its rows, then only k (score, global-id) candidates per
        # shard cross the interconnect — or, for large fp32 batches,
        # the ring route (exchange overlapped with compute).
        packed = _mesh_exact_packed(
            cache, req.source, req.column, metric, req.precision,
            queries, q_pad, k_pad, plan, corpus,
        )
    else:
        aux_mul, aux_add = cache.metric_aux(req.source, req.column, metric)
        aux_add = plan.overlay(aux_add, "flat")
        corpus_scan = (
            cache.matrix_bf16(req.source, req.column).data
            if req.precision == "bf16"
            else None
        )
        corpus_scan_int8 = None
        if req.precision == "int8":
            v8, sv = cache.matrix_int8(req.source, req.column)
            corpus_scan_int8 = (v8.data, sv.data)
        packed = _search_packed(
            corpus.data,
            queries,
            aux_mul,
            aux_add,
            k=k_pad,
            metric=metric,
            corpus_scan=corpus_scan,
            corpus_scan_int8=corpus_scan_int8,
        )

    _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
    dists, ids = topk2.unpack_result(packed)  # single roundtrip fetch
    return gather_results(
        data, select, dists[:num_queries, :k], ids[:num_queries, :k], value_dtype,
        views=views,
    )


def _execute_nomax(
    cache: DeviceCache,
    req: SearchRequest,
    data: pa.Table,
    corpus,
    plan: _FilterPlan,
    coding_data,
    metric: str,
    target: np.ndarray,
    value_dtype,
    select: Sequence[str],
    snap_stamp: tuple,
    views: "dict | None" = None,
) -> pa.Table:
    """No-top-k read (``maxval=None``): every selected row with its
    exact distance, streamed through the device (fenix_tpu.ops.select) —
    host transfer O(selected rows), never the full [Q, N] matrix.
    Reference index.py:162 semantics, incl. probe pruning AND'd into
    the filter (index.py:113-126)."""
    from fenix_tpu.ops import select as select_ops

    rows, n_pad = corpus.rows, corpus.rows_padded
    num_queries = target.shape[0]

    if not plan.active and coding_data is None:
        # Full read: the OUTPUT is [Q, rows] — fetching the distance
        # matrix IS the result; nothing to push down.
        dists = np.asarray(
            distance_ops.all_distances(corpus.data, jnp.asarray(target), metric=metric)
        )[:, :rows]
        _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
        tables = []
        for qi in range(num_queries):
            part = data.append_column(
                DIST_COL, pa.array(dists[qi].astype(value_dtype))
            ).select(select)
            if num_queries > 1:
                part = part.append_column(
                    QUERY_COL, pa.array(np.full(len(part), qi, dtype=np.int64))
                )
            tables.append(part)
        return pa.concat_tables(tables).combine_chunks()

    q_pad = _canonical_q(num_queries)
    padded = target
    if q_pad != num_queries:
        padded = np.concatenate(
            [target, np.zeros((q_pad - num_queries, target.shape[1]), np.float32)]
        )
    queries = jnp.asarray(padded)

    sharded = cache.mesh is not None
    fmask = None
    if plan.active:
        if plan.pushdown:
            fmask = cache.device_filter_mask(req.source, req.filter, sharded=sharded)
            if fmask is not None:
                if fmask.shape[0] != n_pad:
                    raise _StaleRevision
                METRICS.add("filter.device_pushdown")
        if fmask is None:
            METRICS.add("filter.host_upload")
            m = plan.host_mask()
            if m.shape[0] != n_pad:
                raise _StaleRevision
            fmask = _sharded_mask(cache.mesh, m) if sharded else jnp.asarray(m)

    coded = cells_sorted = None
    if coding_data is not None:
        cells = _rank_cells(target, coding_data, metric, int(req.probes))
        if q_pad != num_queries:
            cells = np.concatenate(
                [cells, np.full((q_pad - num_queries, cells.shape[1]), -1, cells.dtype)]
            )
        # sorted per query for the kernels' searchsorted membership
        cells_sorted = jnp.asarray(np.sort(cells, axis=1).astype(np.int32))
        coded_col = cache.coded_ids(req.coding, req.source, req.column, sharded=sharded)
        if coded_col.rows_padded != n_pad:
            raise _StaleRevision
        coded = coded_col.data

    chunk = select_ops.chunk_for(n_pad, q_pad, cache.block)
    rows_t = jnp.int32(rows)
    if coded is not None:
        counts = np.asarray(
            select_ops.count_selected_probed(fmask, coded, cells_sorted, rows_t, chunk=chunk)
        )  # [n_chunks, Q]
        chunk_max = counts.max(axis=1)
    else:
        chunk_max = np.asarray(
            select_ops.count_selected_mask(fmask, rows_t, chunk=chunk)
        )  # [n_chunks]

    # compaction dispatches only for chunks holding matches; width is
    # the chunk's max per-query count, canonicalized to a power of two
    # so the jit cache stays bounded
    ids_parts: list[np.ndarray] = []
    dist_parts: list[np.ndarray] = []
    for ci, mc in enumerate(chunk_max):
        mc = int(mc)
        if mc == 0:
            continue
        width = min(_canonical_k(mc), chunk)
        ids_c, d_c = select_ops.compact_chunk(
            corpus.data, queries, fmask, coded, cells_sorted,
            jnp.int32(ci * chunk), rows_t,
            metric=metric, chunk=chunk, width=width,
        )
        d_np, ids_np = topk2.unpack_result(topk2.pack_result(d_c, ids_c))
        ids_parts.append(ids_np[:num_queries])
        dist_parts.append(d_np[:num_queries])

    _check_revision(cache, req.source, req.column, req.coding, snap_stamp)
    if not ids_parts:
        ids_all = np.full((num_queries, 1), -1, np.int32)
        d_all = np.full((num_queries, 1), np.inf, np.float32)
    else:
        # chunk-major concat keeps each query's rows in ascending
        # (table) order — the reference's filter-preserved order
        ids_all = np.concatenate(ids_parts, axis=1)
        d_all = np.concatenate(dist_parts, axis=1)
    return gather_results(data, select, d_all, ids_all, value_dtype, views=views)


def batchable(req: SearchRequest) -> bool:
    """Whether a request can join a coalesced device dispatch.

    Filtered requests batch with requests carrying the IDENTICAL
    predicate (the batch key carries the filter's wire form): the
    shared [N] aux_add overlay then applies to the whole batch, and
    mixed-predicate workloads coalesce into one dispatch per distinct
    predicate instead of one per request. Probed requests batch with
    identical (coding, probes) — probe cells are per-query inputs to
    the kernels. maxval may differ across a batch — ascending top-k
    means each request's top-m is a prefix of the batch's top-k."""
    return (
        req.maxval is not None
        and req.metric is not None
        and (req.coding is None or req.probes is not None)
    )


def batch_key(req: SearchRequest) -> tuple:
    source = (req.source,) if isinstance(req.source, str) else tuple(req.source)
    return (
        source,
        req.column,
        distance_ops.canonical_metric(req.metric),
        req.precision,
        req.residency,
        req.coding,
        req.probes,
        expr_mod.dumps(req.filter),
    )


def execute_search_batched(
    cache: DeviceCache, reqs: Sequence[SearchRequest], defer: bool = False
) -> "list[pa.Table] | Callable[[], list[pa.Table]]":
    """Run compatible requests (same batch_key, all batchable) as ONE
    device dispatch. Each dispatch pays a fixed host-side cost; N
    concurrent searches coalesced into one [sum(Q_i), D] call amortize
    it N-fold.

    With ``defer=True`` the device work is dispatched asynchronously and
    a ``finish()`` closure is returned; calling it blocks on the
    device→host fetch and materializes the result tables. This lets the
    batcher dispatch the NEXT batch while the previous one's results
    are read back."""
    for _ in range(4):
        try:
            return _execute_search_batched_once(cache, reqs, defer)
        except _StaleRevision:
            continue
    raise RuntimeError(f"table {reqs[0].source!r} kept changing during search")


def _execute_search_batched_once(
    cache: DeviceCache, reqs: Sequence[SearchRequest], defer: bool
) -> "list[pa.Table] | Callable[[], list[pa.Table]]":
    r0 = reqs[0]

    from fenix_tpu.engine import residency

    mode = residency.plan(cache, r0)
    if mode != residency.DUAL:
        # host-corpus modes: one stacked dispatch, results split per
        # request (batch_key carries residency, so the group is uniform)
        tables = residency.execute_many(cache, reqs, mode)
        return (lambda: tables) if defer else tables

    data, corpus, snap_stamp = cache.snapshot(r0.source, r0.column, coding=r0.coding)
    column_type = ingest.vector_type(data.schema.field(r0.column).type)
    value_dtype = column_type.value_type.to_pandas_dtype()
    dim = column_type.list_size
    metric = distance_ops.canonical_metric(r0.metric)
    rows = corpus.rows
    views = cache.host_column_views(r0.source, data, snap_stamp, r0.coding)

    targets = [normalize_target(r.target, dim) for r in reqs]
    counts = [t.shape[0] for t in targets]
    total = sum(counts)

    k = int(min(max(r.maxval for r in reqs), rows))
    q_pad = _canonical_q(total)
    k_pad = min(_canonical_k(k), corpus.rows_padded)

    stacked = np.concatenate(targets) if len(targets) > 1 else targets[0]
    queries = jnp.asarray(stacked)
    if q_pad != total:
        queries = jnp.concatenate(
            [queries, jnp.zeros((q_pad - total, dim), queries.dtype)]
        )

    # batch members share one predicate (batch_key carries its wire
    # form), so the solo path's overlay applies to the whole batch
    plan = _FilterPlan(
        cache, r0.source, r0.column, r0.filter, data, corpus.rows_padded, rows
    )

    if r0.coding is not None:
        # probed batch (same coding+probes across the group): identical
        # kernel routing to execute_search's coding branch, over the
        # concatenated query batch.
        coding_data = cache.coding(r0.coding)
        cells = _rank_cells(stacked, coding_data, metric, int(r0.probes))
        if q_pad != total:
            cells = np.concatenate(
                [cells, np.full((q_pad - total, cells.shape[1]), -1, cells.dtype)]
            )
        if cache.mesh is not None:
            packed = _mesh_probed_packed(
                cache, r0.coding, r0.source, r0.column, coding_data,
                queries, cells, q_pad, k_pad, metric, plan, r0.precision,
            )
        else:
            n_pad = corpus.rows_padded
            use_clustered = _clustered_eligible(coding_data)
            bucket_lists = None
            if use_clustered:
                perm, offsets = cache.clustered_meta(r0.coding, r0.source, r0.column)
                if plan.active and perm.shape[0] != n_pad:
                    raise _StaleRevision
                bucket = topk2.bucket_for(q_pad, n_pad)
                bucket_lists = _ivf_bucket_lists(cells, offsets, bucket, n_pad // bucket)
                use_clustered = q_pad * bucket_lists.shape[1] * bucket <= n_pad
            if use_clustered:
                corpus_s, coded_s, orig_ids = cache.clustered(
                    r0.coding, r0.source, r0.column
                )
                aux_mul_s, aux_add_s = cache.clustered_aux(
                    r0.coding, r0.source, r0.column, metric
                )
                aux_add_s = plan.overlay(aux_add_s, "clustered", r0.coding)
                packed = _search_ivf_packed(
                    corpus_s.data,
                    queries,
                    aux_mul_s,
                    aux_add_s,
                    coded_s.data,
                    orig_ids.data,
                    cells,
                    jnp.asarray(bucket_lists),
                    k=k_pad,
                    metric=metric,
                )
            else:
                coded = cache.coded_ids(r0.coding, r0.source, r0.column)
                aux_mul, aux_add = cache.metric_aux(r0.source, r0.column, metric)
                aux_add = plan.overlay(aux_add, "flat")
                packed = _search_probed_packed(
                    corpus.data, queries, aux_mul, aux_add, coded.data, cells,
                    k=k_pad, metric=metric,
                    **_scan_copies(cache, r0.source, r0.column, r0.precision, sharded=False),
                )
    elif cache.mesh is not None:
        packed = _mesh_exact_packed(
            cache, r0.source, r0.column, metric, r0.precision,
            queries, q_pad, k_pad, plan, corpus,
        )
    else:
        aux_mul, aux_add = cache.metric_aux(r0.source, r0.column, metric)
        aux_add = plan.overlay(aux_add, "flat")
        corpus_scan = (
            cache.matrix_bf16(r0.source, r0.column).data
            if r0.precision == "bf16"
            else None
        )
        corpus_scan_int8 = None
        if r0.precision == "int8":
            v8, sv = cache.matrix_int8(r0.source, r0.column)
            corpus_scan_int8 = (v8.data, sv.data)

        packed = _search_packed(
            corpus.data,
            queries,
            aux_mul,
            aux_add,
            k=k_pad,
            metric=metric,
            corpus_scan=corpus_scan,
            corpus_scan_int8=corpus_scan_int8,
        )

    _check_revision(cache, r0.source, r0.column, r0.coding, snap_stamp)

    def finish() -> list[pa.Table]:
        dists, ids = topk2.unpack_result(packed)  # blocks: device→host fetch
        out = []
        offset = 0
        for req, c in zip(reqs, counts):
            m = int(min(req.maxval, rows))
            select = [*req.select] if req.select is not None else data.column_names
            select = select + [DIST_COL]
            out.append(
                gather_results(
                    data,
                    select,
                    dists[offset : offset + c, :m],
                    ids[offset : offset + c, :m],
                    value_dtype,
                    views=views,
                )
            )
            offset += c
        return out

    return finish if defer else finish()


def gather_results(
    data: pa.Table,
    select: Sequence[str],
    dists: np.ndarray,  # [Q, k]
    ids: np.ndarray,  # [Q, k] (−1 padding)
    value_dtype,
    views: "dict | None" = None,
) -> pa.Table:
    """Host-side result materialization: take winning rows, append the
    distance column, add ``__QUERY_ID__`` for multi-query batches.

    Fast path (``views`` from session.host_column_views): columns with
    zero-copy numpy views gather via the threaded native path and wrap
    straight into single-chunk Arrow arrays — the full-table Arrow
    ``take`` measured 4.2 ms of a config-5 batch on chip
    (benchmarks/exp_cfg5_decomp.py; VERDICT r3 weak #3). Columns
    without a view (strings, extension types, nullable) fall back to a
    per-column Arrow take, preserving their exact result types."""
    from fenix_tpu import native
    from fenix_tpu.utils import profiling

    with profiling.annotate("fenix.result_gather"):
        num_queries, k = ids.shape
        valid = ids >= 0  # [Q, k]
        row_ids = ids[valid].astype(np.int64)

        names: list[str] = []
        arrays: list[pa.Array | pa.ChunkedArray] = []
        ids_arr: pa.Array | None = None
        for name in select:
            if name == DIST_COL:
                names.append(DIST_COL)
                arrays.append(pa.array(dists[valid].astype(value_dtype)))
                continue
            view = views.get(name) if views is not None else None
            if view is not None:
                v, value_type = view
                if v.ndim == 2:
                    gathered = native.gather_rows(v, row_ids)
                    arr = ingest.numpy_to_fixed_size_list(gathered, value_type)
                else:
                    arr = pa.array(v[row_ids])
            else:
                if ids_arr is None:
                    ids_arr = pa.array(row_ids)
                arr = data.column(name).take(ids_arr)
                if isinstance(arr, pa.ChunkedArray):
                    arr = arr.combine_chunks()  # result-sized, cheap
            names.append(name)
            arrays.append(arr)

        if num_queries > 1:
            qids = np.broadcast_to(
                np.arange(num_queries, dtype=np.int64)[:, None], (num_queries, k)
            )[valid]
            names.append(QUERY_COL)
            arrays.append(pa.array(qids))
        return pa.table(dict(zip(names, arrays)))
