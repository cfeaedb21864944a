"""Smoke run of the Flight search path on one NVIDIA GPU, at real sizes.

    python chip_smoke.py [--seed N]      # one card: every phase below
    python chip_smoke.py --four-cards    # four cards: the mesh paths only

One process per card: a ``fenix_tpu.Server`` runs in a thread of this
process and the main thread drives it with the ``fenix_tpu.Flight``
client. Data is generated from ``--seed``; the reference is float64
numpy, chunked over rows, checked on up to ``check_queries`` queries
per batch. Phases (each prints one line; any failure exits nonzero):

1. environment: jax, device, card name and power limit, pyarrow,
   compile-cache directory, native library;
2. BASELINE config 1 at full scale: 1,048,576 × 128 fp32, cosine,
   top-10; table round trip; Q = 1, 8, 96, 1024; bf16 and int8 scans;
3. config-2 shape: 768-d, L2, top-100, int ``tag`` filter keeping ~10 %,
   Q = 8 and 1024, at 2,097,152 rows (cut from config 2's 10M rows for
   run time);
4. IVF: 2 codebooks × 64, probes=16, Q = 8 and 1024; device cell
   assignment against the host twin;
5. residency: int8-resident and streaming routes under a device budget
   below the phase-3 corpus, against the resident answer;
6. join + group-by count against a 1M-row attribute table;
7. mutations: appended rows are found by a probed search, deleted rows
   never return;
8. the ``gpu``-marked tests, in a child process that ends before this
   process first touches the card.

Tolerances: distances rtol 1e-4, atol 1e-5 (the CPU suite's own); ids
exactly, except where the returned row's float64 distance ties the
reference's at that rank within that tolerance; bf16/int8 scans need
recall@k ≥ 0.999. The last stdout line is one JSON object naming the
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-5
RECALL_MIN = 0.999
PROBE_TIE = 1e-6  # relative cell-score gap below which a probe set is ambiguous


@dataclasses.dataclass(frozen=True)
class Sizes:
    n1: int = 1 << 20  # config 1 rows
    d1: int = 128
    k1: int = 10
    qs1: tuple = (1, 8, 96, 1024)
    n2: int = 2 << 20  # config-2 shape rows (config 2 itself: 10M)
    d2: int = 768
    k2: int = 100
    qs2: tuple = (8, 1024)
    book_size: int = 64
    books: int = 2
    probes: int = 16
    attrs: int = 1 << 20
    appended: int = 16384
    n4: int = 8 << 20  # four-card corpus rows
    check_queries: int = 64
    batch_rows: int = 1 << 16  # rows per Arrow record batch on the wire


TINY = Sizes(
    n1=4096, d1=16, qs1=(1, 8, 40), n2=8192, d2=24, k2=10, qs2=(8, 40),
    book_size=8, probes=4, attrs=2048, appended=256, n4=8192, check_queries=16,
    batch_rows=1024,
)


# -- float64 reference ------------------------------------------------------


def ref_distances(corpus: np.ndarray, queries: np.ndarray, metric: str) -> np.ndarray:
    """[Q, N] float64 distances (the engine's metric definitions)."""
    c = corpus.astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "l2":
        d2 = (q * q).sum(1)[:, None] - 2.0 * q @ c.T + (c * c).sum(1)[None, :]
        return np.sqrt(np.maximum(d2, 0.0))
    if metric == "cosine":
        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        cn = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12)
        return 0.5 - 0.5 * (qn @ cn.T)
    return -(q @ c.T)


def ref_topk(corpus, queries, metric, k, keep=None, chunk=1 << 18):
    """float64 top-(k+1) per query, ordered by (distance, id); ``keep``
    is a row mask, [N] for every query or [Q, N] per query."""
    nq = queries.shape[0]
    best_d = np.full((nq, 0), np.inf)
    best_i = np.zeros((nq, 0), np.int64)
    for start in range(0, corpus.shape[0], chunk):
        d = ref_distances(corpus[start:start + chunk], queries, metric)
        if keep is not None:
            d[np.broadcast_to(~keep[..., start:start + chunk], d.shape)] = np.inf
        take = min(k + 1, d.shape[1])
        part = np.argpartition(d, take - 1, axis=1)[:, :take]
        best_d = np.concatenate([best_d, np.take_along_axis(d, part, 1)], 1)
        best_i = np.concatenate([best_i, part + start], 1)
        order = np.lexsort((best_i, best_d))[:, : k + 1]
        best_d = np.take_along_axis(best_d, order, 1)
        best_i = np.take_along_axis(best_i, order, 1)
    return best_d, best_i


def check_rows(nq: int, limit: int) -> np.ndarray:
    return np.unique(np.linspace(0, nq - 1, min(nq, limit)).astype(np.int64))


def check_search(label, got_i, got_d, corpus, queries, metric, k, sizes,
                 keep=None, exact=True, rows=None) -> str:
    """Compare one batch's answer with the float64 reference on ``rows``
    (default: up to ``check_queries`` spread over the batch); ``keep``
    is [N], or [len(rows), N] per checked query."""
    if rows is None:
        rows = check_rows(queries.shape[0], sizes.check_queries)
    want_d, want_i = ref_topk(corpus, queries[rows], metric, k, keep)
    recalls = []
    for r, row in enumerate(rows):
        gi, gd = got_i[row], got_d[row]
        assert (gi >= 0).all() and len(set(gi.tolist())) == k, (label, row, gi)
        if keep is not None:
            assert (keep if keep.ndim == 1 else keep[r])[gi].all(), (
                label, "excluded row returned", row)
        exact_d = ref_distances(corpus[gi], queries[row:row + 1], metric)[0]
        np.testing.assert_allclose(gd, exact_d, rtol=RTOL, atol=ATOL, err_msg=label)
        recalls.append(len(set(gi.tolist()) & set(want_i[r, :k].tolist())) / k)
        if exact:
            np.testing.assert_allclose(gd, want_d[r, :k], rtol=RTOL, atol=ATOL,
                                       err_msg=label)
            tie = np.abs(exact_d - want_d[r, :k]) <= ATOL + RTOL * np.abs(want_d[r, :k])
            bad = (gi != want_i[r, :k]) & ~tie
            assert not bad.any(), (label, row, gi[bad], want_i[r, :k][bad])
    recall = float(np.mean(recalls))
    if not exact:
        assert recall >= RECALL_MIN, (label, recall)
    return f"{label} recall@{k}={recall:.4f} over {len(rows)} queries"


# -- driving the server -----------------------------------------------------


class Smoke:
    """One in-process server, its client, and the generated data."""

    def __init__(self, root: str, sizes: Sizes, seed: int) -> None:
        import fenix_tpu

        self.root, self.sizes = root, sizes
        self.rng = np.random.default_rng(seed)
        self.server = fenix_tpu.Server(root, host="127.0.0.1", port=0)
        self.thread = threading.Thread(target=self.server.serve, daemon=True)
        self.thread.start()
        self.client = fenix_tpu.Flight(host="127.0.0.1", port=self.server.port)
        self.data: dict = {}

    def close(self) -> None:
        self.client.close()
        self.server.shutdown()
        self.thread.join(timeout=30)

    def put(self, name: str, columns: dict, append: bool = False) -> None:
        import pyarrow as pa

        from fenix_tpu.io import ingest

        n = len(next(iter(columns.values())))
        step = self.sizes.batch_rows

        def batches():
            for s in range(0, n, step):
                cols = {}
                for key, v in columns.items():
                    cols[key] = (
                        ingest.numpy_to_fixed_size_list(v[s:s + step], pa.float32())
                        if v.ndim == 2 else pa.array(v[s:s + step])
                    )
                yield pa.record_batch(list(cols.values()), names=list(cols))

        first = next(batches())
        reader = pa.RecordBatchReader.from_batches(first.schema, batches())
        (self.client.append_table if append else self.client.make_table)(name, reader)

    def search(self, queries, source, metric, k, **kw):
        """(ids [Q, k], distances [Q, k]) in (distance, id) order."""
        q = queries.shape[0]
        res = self.client.search(
            queries if q > 1 else queries[0], source, "vector", metric,
            maxval=k, select=["id"], **kw,
        )
        ids = np.asarray(res.column("id"), np.int64)
        dist = np.asarray(res.column("__DISTANCE__"), np.float64)
        qid = np.asarray(res.column("__QUERY_ID__")) if q > 1 else np.zeros_like(ids)
        order = np.lexsort((ids, dist, qid))
        assert ids.shape[0] == q * k, (source, ids.shape, q, k)
        return ids[order].reshape(q, k), dist[order].reshape(q, k)

    def queries(self, q: int, d: int) -> np.ndarray:
        return self.rng.standard_normal((q, d), dtype=np.float32)


def phase_environment(sizes: Sizes | None = None) -> str:
    import jax
    import pyarrow

    from fenix_tpu import native
    from fenix_tpu.utils.jax_cache import configure_compile_cache

    cache_dir = configure_compile_cache()
    t0 = time.perf_counter()
    lib = native.build()
    built = time.perf_counter() - t0
    dev = jax.devices()[0]
    return (
        f"jax {jax.__version__}; device {dev.platform} {dev.device_kind!r} "
        f"x{len(jax.devices())}; card {card_line()!r}; pyarrow "
        f"{pyarrow.__version__}; compile cache {cache_dir}; native library "
        f"{'built' if lib else 'MISSING (numpy fallback)'} ({built:.1f} s)"
    )


def phase_config1(s: Smoke) -> str:
    from fenix_tpu import expr

    z = s.sizes
    corpus = s.rng.standard_normal((z.n1, z.d1), dtype=np.float32)
    s.data["c1"] = corpus
    s.put("smoke/c1", {"id": np.arange(z.n1, dtype=np.int64), "vector": corpus})
    sample = min(z.n1, 1 << 16)
    back = s.client.read_table("smoke/c1", filter=expr.field("id") < sample).read_all()
    from fenix_tpu.io import ingest

    assert np.array_equal(np.asarray(back.column("id")), np.arange(sample))
    assert np.array_equal(ingest.fixed_size_list_to_numpy(back.column("vector")),
                          corpus[:sample])
    parts = [f"round trip {sample} rows equal"]
    for q in z.qs1:
        queries = s.queries(q, z.d1)
        ids, dist = s.search(queries, "smoke/c1", "cosine", z.k1)
        parts.append(check_search(f"Q={q} fp32", ids, dist, corpus, queries,
                                  "cosine", z.k1, z))
    queries = s.queries(z.qs1[-1], z.d1)
    for precision in ("bf16", "int8"):
        ids, dist = s.search(queries, "smoke/c1", "cosine", z.k1, precision=precision)
        parts.append(check_search(f"Q={queries.shape[0]} {precision}", ids, dist,
                                  corpus, queries, "cosine", z.k1, z, exact=False))
    return f"{z.n1}x{z.d1} cosine top-{z.k1}: " + "; ".join(parts)


def phase_config2(s: Smoke) -> str:
    from fenix_tpu import expr

    z = s.sizes
    corpus = s.rng.standard_normal((z.n2, z.d2), dtype=np.float32)
    tag = s.rng.integers(0, 10, z.n2).astype(np.int64)
    s.data["c2"], s.data["tag"] = corpus, tag
    s.put("smoke/c2", {"id": np.arange(z.n2, dtype=np.int64), "tag": tag,
                       "vector": corpus})
    keep = tag == 0
    parts = []
    for q in z.qs2:
        queries = s.queries(q, z.d2)
        ids, dist = s.search(queries, "smoke/c2", "l2", z.k2,
                             filter=expr.field("tag") == 0)
        parts.append(check_search(f"Q={q} filtered", ids, dist, corpus, queries,
                                  "l2", z.k2, z, keep=keep))
    return (f"{z.n2}x{z.d2} l2 top-{z.k2}, tag filter keeps {keep.mean():.3f} "
            f"(rows cut from config 2's 10M for run time): " + "; ".join(parts))


def cell_scores64(queries, codebooks) -> np.ndarray:
    """[Q, k^n] float64 composite-cell scores (l2, codebook 0 most
    significant), the float64 twin of ops.cells' dense enumeration."""
    n, k, _ = codebooks.shape
    per = [ref_distances(codebooks[b], queries, "l2") for b in range(n)]  # [Q, k]
    score = per[0]
    for b in range(1, n):
        score = (score[:, :, None] + per[b][:, None, :]).reshape(queries.shape[0], -1)
    return score


def phase_ivf(s: Smoke) -> str:
    import jax.numpy as jnp

    from fenix_tpu import coder
    from fenix_tpu.ops import cells

    z = s.sizes
    corpus = s.data["c2"]
    s.client.make_index("smoke/ivf", "smoke/c2", "vector", {
        "metric": "l2", "codebook_size": z.book_size, "num_codebooks": z.books,
        "batch_size": 4096, "num_epochs": 2,
    })
    books = coder.load(s.root, "smoke/ivf")["tensor"]
    coded = np.asarray(
        s.client.read_table("smoke/c2", "smoke/ivf", "vector", select=["id", "__CODED_ID__"])
        .read_all().column("__CODED_ID__"), np.int64,
    )
    s.data["books"], s.data["coded"] = books, coded

    # device assignment (the stored codes, and a direct call) vs the host twin
    rows = np.arange(min(z.n2, 1 << 16))
    host = cells.assign_cells_np(corpus[rows], books, "l2")
    dev = np.asarray(cells.assign_cells(jnp.asarray(corpus[rows]), jnp.asarray(books), "l2"))
    differ = np.flatnonzero((host != dev) | (host != coded[rows]))
    for r in differ:  # allowed only where the two cells tie in float64
        sc = cell_scores64(corpus[r:r + 1], books)[0]
        assert abs(sc[host[r]] - sc[coded[r]]) <= ATOL + RTOL * abs(sc[host[r]]), r
    parts = [f"assignment device == host on {len(rows)} rows "
             f"({len(differ)} float64 ties)"]

    for q in z.qs2:
        queries = s.queries(q, z.d2)
        ids, dist = s.search(queries, "smoke/c2", "l2", z.k2, coding="smoke/ivf",
                             probes=z.probes)
        check = check_rows(q, z.check_queries)
        scores = cell_scores64(queries[check], books)
        clear, keep = [], []
        for r, row in enumerate(check):
            order = np.lexsort((np.arange(scores.shape[1]), scores[r]))
            probe, nxt = order[: z.probes], order[z.probes]
            gap = scores[r, nxt] - scores[r, probe[-1]]
            # the host ranks cells in fp32: about 1e-7 relative error
            if gap <= PROBE_TIE * abs(scores[r, nxt]):
                # probe set ambiguous in float64: check distances only
                exact_d = ref_distances(corpus[ids[row]], queries[row:row + 1], "l2")[0]
                np.testing.assert_allclose(dist[row], exact_d, rtol=RTOL, atol=ATOL)
                continue
            clear.append(row)
            keep.append(np.isin(coded, probe))
        tied = len(check) - len(clear)
        if clear:
            check_search(f"IVF Q={q}", ids, dist, corpus, queries, "l2", z.k2, z,
                         keep=np.stack(keep), rows=np.asarray(clear))
        parts.append(f"Q={q} probes={z.probes} exact within float64-ranked probe "
                     f"cells on {len(check)} queries ({tied} probe-boundary ties)")
    return f"{z.books}x{z.book_size} coder on {z.n2}x{z.d2}: " + "; ".join(parts)


def phase_residency(s: Smoke) -> str:
    from fenix_tpu.utils.metrics import GLOBAL as metrics

    z = s.sizes
    queries = s.queries(8, z.d2)
    want_i, want_d = s.search(queries, "smoke/c2", "l2", z.k2, residency="dual")
    # the largest budget (halving from the fp32 corpus size) under which
    # the router's own rule plans the int8 route for this table
    from fenix_tpu.engine import executor, residency

    cache = executor.get_cache(s.root)
    req = executor.SearchRequest(source="smoke/c2", column="vector",
                                 target=queries, metric="l2", maxval=z.k2)
    budget = z.n2 * z.d2 * 4
    parts = []
    try:
        while True:
            os.environ["FENIX_HBM_BUDGET"] = str(budget)
            route = residency.plan(cache, req)
            if route != residency.DUAL:
                break
            budget //= 2
        assert route == residency.INT8, route
        for mode, counter in (("auto", "search.residency_int8"),
                              ("stream", "search.residency_stream")):
            before = metrics.snapshot().get(counter, 0)
            ids, dist = s.search(queries, "smoke/c2", "l2", z.k2, residency=mode)
            moved = metrics.snapshot().get(counter, 0) - before
            assert moved > 0, (mode, counter, "route not taken")
            np.testing.assert_allclose(dist, want_d, rtol=RTOL, atol=ATOL)
            tie = np.abs(dist - want_d) <= ATOL + RTOL * np.abs(want_d)
            assert ((ids == want_i) | tie).all(), mode
            parts.append(f"{mode}: {counter} +{moved}, ids == resident "
                         f"({int((ids != want_i).sum())} tie swaps)")
    finally:
        del os.environ["FENIX_HBM_BUDGET"]
    return (f"FENIX_HBM_BUDGET={budget} (fp32 corpus {z.n2 * z.d2 * 4} B does not "
            f"fit, its int8 copy does): " + "; ".join(parts))


def phase_join(s: Smoke) -> str:
    from collections import Counter

    z = s.sizes
    keys = s.rng.permutation(z.n1)[: min(z.attrs, z.n1)].astype(np.int64)
    grp = (keys % 16).astype(np.int64)
    s.put("smoke/attrs", {"key": keys, "grp": grp})
    query = s.queries(1, z.d1)
    k = 100
    res = s.client.search(
        query[0], "smoke/c1", "vector", "cosine", maxval=k,
        join={"source": "smoke/attrs", "right_on": "key"},
        aggregate={"group_by": "grp", "agg": "count", "max_groups": 16},
    )
    got = dict(zip(np.asarray(res.column("__GROUP__")).tolist(),
                   np.asarray(res.column("__AGG__")).tolist()))
    _, top = ref_topk(s.data["c1"], query, "cosine", k)
    lookup = dict(zip(keys.tolist(), grp.tolist()))
    want = Counter(lookup[i] for i in top[0, :k].tolist() if i in lookup)
    assert got == {g: float(c) for g, c in want.items()}, (got, want)
    return (f"top-{k} of {z.n1} rows joined to {len(keys)} attribute rows, "
            f"count by 16 groups == numpy ({sum(want.values())} matches)")


def phase_mutations(s: Smoke) -> str:
    from fenix_tpu import expr

    z = s.sizes
    extra = s.rng.standard_normal((z.appended, z.d2), dtype=np.float32)
    new_ids = np.arange(z.n2, z.n2 + z.appended, dtype=np.int64)
    s.put("smoke/c2", {"id": new_ids, "tag": np.zeros(z.appended, np.int64),
                       "vector": extra}, append=True)
    pick = check_rows(z.appended, 8)
    ids, dist = s.search(extra[pick], "smoke/c2", "l2", 10, coding="smoke/ivf",
                         probes=z.probes)
    assert (ids[:, 0] == new_ids[pick]).all(), (ids[:, 0], new_ids[pick])
    # the l2 form |q|² − 2q·v + |v|² cancels to ~0 here: sqrt of its fp32
    # rounding, not a distance error
    assert (dist[:, 0] < 0.1).all(), dist[:, 0]
    deleted = s.client.delete_rows("smoke/c2", expr.field("id") >= z.n2)
    assert deleted == z.appended, deleted
    for kw in ({"coding": "smoke/ivf", "probes": z.probes}, {}):
        ids, _ = s.search(extra[pick], "smoke/c2", "l2", 10, **kw)
        assert (ids < z.n2).all(), ("deleted row returned", kw)
    return (f"appended {z.appended} rows: probed search finds each at rank 0; "
            f"deleted {deleted}: none returned (probed and exact)")


def phase_gpu_tests() -> str:
    """The gpu-marked tests, in a child; the parent has not touched JAX."""
    env = dict(os.environ, FENIX_TESTS_GPU="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        env=env, capture_output=True, text=True, timeout=600,
    )
    tail = (out.stdout.strip().splitlines() or [""])[-1]
    if out.returncode != 0 or "passed" not in tail or "skipped" in tail:
        sys.stderr.write(out.stdout[-8000:] + out.stderr[-4000:])
        raise AssertionError(f"gpu-marked tests: rc={out.returncode}: {tail}")
    return tail


def run_one_card(sizes: Sizes, seed: int, root: str) -> list[str]:
    lines = []
    s = Smoke(root, sizes, seed)
    try:
        for name, fn in (("config1", phase_config1), ("config2", phase_config2),
                         ("ivf", phase_ivf), ("residency", phase_residency),
                         ("join", phase_join), ("mutations", phase_mutations)):
            t0 = time.perf_counter()
            summary = fn(s)
            lines.append(f"phase {name}: ok {summary} ({time.perf_counter() - t0:.1f} s)")
            print(lines[-1], flush=True)
    finally:
        s.close()
    return lines


# -- four cards ---------------------------------------------------------------


def run_four_cards(sizes: Sizes, seed: int, root: str, devices: int = 4) -> list[str]:
    """Mesh paths over every visible device, each against the one-card
    answer from a second DeviceCache with ``mesh=None``."""
    import jax

    from fenix_tpu.engine import analytics, executor, session
    from fenix_tpu.utils.metrics import GLOBAL as metrics

    assert len(jax.devices()) == devices, jax.devices()
    os.environ.pop("FENIX_MESH", None)
    lines = []
    s = Smoke(root, sizes, seed)
    try:
        corpus = s.rng.standard_normal((sizes.n4, sizes.d1), dtype=np.float32)
        s.put("mesh/c", {"id": np.arange(sizes.n4, dtype=np.int64), "vector": corpus})
        keys = s.rng.permutation(sizes.n4)[: sizes.attrs].astype(np.int64)
        s.put("mesh/attrs", {"key": keys, "grp": (keys % 16).astype(np.int64)})
        single = session.DeviceCache(root, mesh=None)

        def one_card(queries, k, **kw):
            res = executor.execute_search(single, executor.SearchRequest(
                source="mesh/c", column="vector", target=queries, metric="l2",
                maxval=k, select=["id"], **kw))
            return np.asarray(res.column("id"), np.int64).reshape(queries.shape[0], k)

        os.environ.pop("FENIX_RING", None)  # Q=1024 is past the ring threshold
        for label, q, kw, counter in (
            ("row-sharded exact + candidate merge", 8, {}, None),
            ("ring route", 1024, {}, None),
            ("row-sharded int8 residency", 8, {"residency": "int8"},
             "search.residency_int8"),
        ):
            queries = s.queries(q, sizes.d1)
            before = metrics.snapshot().get(counter, 0)
            ids, _ = s.search(queries, "mesh/c", "l2", 10, **kw)
            assert counter is None or metrics.snapshot().get(counter, 0) > before, label
            want = one_card(queries, 10, **kw)
            assert (ids == want).all(), (label, int((ids != want).sum()))
            lines.append(f"phase mesh {label} Q={q}: ok, ids == one-card answer")
            print(lines[-1], flush=True)

        query = s.queries(1, sizes.d1)
        join = {"source": "mesh/attrs", "right_on": "key", "partitioned": True}
        agg = {"group_by": "grp", "agg": "count", "max_groups": 16}
        before = metrics.snapshot().get("join.partitioned", 0)
        res = s.client.search(query[0], "mesh/c", "vector", "l2", maxval=100,
                              join=join, aggregate=agg)
        assert metrics.snapshot().get("join.partitioned", 0) > before
        want = analytics.execute_search_join(
            single,
            executor.SearchRequest(source="mesh/c", column="vector", target=query,
                                   metric="l2", maxval=100),
            analytics.JoinSpec(source="mesh/attrs", right_on="key", partitioned=False),
            analytics.AggregateSpec.from_dict(agg),
        )
        assert res.sort_by("__GROUP__").equals(want.sort_by("__GROUP__")), (res, want)
        lines.append("phase mesh partitioned join: ok, == one-card replicated join")
        print(lines[-1], flush=True)
    finally:
        s.close()
    return lines


# -- entry point --------------------------------------------------------------


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the mesh paths, on four cards")
    args = p.parse_args()

    if importlib.util.find_spec("fenix_tpu") is None:
        sys.exit("chip_smoke.py runs from the root of a fenix_tpu checkout")
    try:
        card = card_line()
    except (OSError, subprocess.CalledProcessError):
        sys.exit("no NVIDIA GPU: nvidia-smi is missing or failed")

    lines = []
    if not args.four_cards:
        os.environ["FENIX_MESH"] = "off"  # one card, even where more are visible
        lines.append(f"phase gpu-tests: ok {phase_gpu_tests()}")  # before JAX
        print(lines[-1], flush=True)

    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"no GPU backend: JAX found {jax.default_backend()!r}")
    lines.insert(0, f"phase environment: ok {phase_environment()}")
    print(lines[0], flush=True)

    with tempfile.TemporaryDirectory(prefix="fenix_smoke_") as root:
        if args.four_cards:
            run_four_cards(Sizes(), args.seed, root)
        else:
            run_one_card(Sizes(), args.seed, root)

    print(card)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
