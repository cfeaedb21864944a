"""BASELINE config 2 AT SPEC: exact top-100 L2 over 10M×768 with a 30%
scalar filter pushed below the kernel, with the fp32 corpus
HOST-resident and the card holding only the int8 scan copy (7.4 GB) +
aux — the layout the residency router picks when the fp32 corpus
(30.7 GB) does not fit the device budget:

  phase A (device, one dispatch): int8 filtered phase-1 bucket scan →
      hierarchical bucket selection (kp = k + 2·BUCKET_PAD buckets) →
      fp32-query × dequantized-int8 narrowing rescore of the gathered
      candidate rows (query-side quantization error eliminated; exact
      −‖v‖² from the host) → top-W candidate ROW ids per query
      (W=4096; only [Q, W] int32 leaves the device)
  host: gather those rows' fp32 vectors from the host corpus
  phase B (device): exact fp32 rescore (HIGHEST) + (dist, id) top-k —
      returned distances are exact fp32, ids tie-break by smallest id

Exactness: selection + narrowing are quantization-graded; the final
ranking is fp32-true over the W-row window. The benchmark ASSERTS
recall@100 == 1.0 against an independent float64 host oracle (VERDICT
r1 #6). Margin arithmetic: the narrowing dot's error is row-side only,
std ≈ √d·(sv/√12)·rms(q′) ≈ 0.6 score units, while the rank-100 →
rank-4096 score gap among the ~18k gathered candidates is tens of
units — a miss needs a >15σ excursion. (W=1024 with an int8×int8
narrowing score measured 799/800 at 200k rows — that one lost row is
why both knobs moved.)

    python -m benchmarks.config2_fullscale
    # --scale 0.1 for a 1M-row smoke run (CPU-able)
"""

from __future__ import annotations

import functools
import time

import numpy as np

from benchmarks import common

WINDOW = 4096  # fp32-rescore window per query (quantization-graded rank)


def main() -> None:
    p = common.parser("config2 full-scale filtered L2 top-100")
    p.add_argument("--window", type=int, default=WINDOW)
    p.add_argument(
        "--root",
        default=None,
        help="(--engine only) reuse an existing root whose 'c2' table "
        "matches --scale — skips gen+ingest AND, when the int8 sidecar "
        "is present from a previous run, the quantize leg of the cold "
        "build (the server-restart warm path); the root is kept",
    )
    p.add_argument(
        "--engine",
        action="store_true",
        help="run THROUGH the executor (int8-resident residency mode, "
        "engine/residency.py) instead of the hand-rolled phases — the "
        "round-4 'engine owns the at-spec path' measurement",
    )
    args = p.parse_args()
    if args.engine:
        return main_engine(args)

    import jax
    import jax.numpy as jnp

    from fenix_tpu.ops import topk2

    n = int(10_000_000 * min(args.scale, 1.0)) // 128 * 128 or 1280
    d, k, q = 768, 128, 8  # top-100 canonicalized to 128 lanes
    w = min(args.window, n)
    bucket = topk2.BUCKET
    nb = n // bucket
    kp = min(k + 2 * topk2.BUCKET_PAD, nb)
    chunk = min(n, 524_288)  # loops handle a ragged tail chunk

    rng = np.random.default_rng(0)
    tags = rng.integers(0, 10, n)
    valid_np = tags < 3  # 30% selectivity scalar predicate

    # --- host corpus (fp32, stays host-resident) + streamed device int8 ----
    t0 = time.perf_counter()
    corpus_np = np.empty((n, d), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        corpus_np[s:e] = rng.standard_normal((e - s, d), dtype=np.float32)
    print(f"# host corpus {corpus_np.nbytes / 1e9:.1f} GB in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    sq_np = np.einsum("nd,nd->n", corpus_np, corpus_np, dtype=np.float32)
    sv_np = np.maximum(np.abs(corpus_np).max(axis=1) / 127.0, 1e-30).astype(np.float32)
    aux_add_np = np.where(valid_np, -sq_np, np.float32(topk2.NEG_INF)).astype(np.float32)

    t0 = time.perf_counter()
    upd = jax.jit(
        lambda buf, c, s: jax.lax.dynamic_update_slice(buf, c, (s, 0)),
        donate_argnums=0,
    )
    v8 = jnp.zeros((n, d), jnp.int8)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        c8 = np.clip(
            np.round(corpus_np[s:e] / sv_np[s:e, None]), -127, 127
        ).astype(np.int8)
        v8 = upd(v8, jnp.asarray(c8), jnp.int32(s))
    common.sync(v8[0, 0])
    print(f"# int8 upload {n * d / 1e9:.1f} GB in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    ams = jnp.asarray(sv_np)  # aux_mul (=1 for l2) folded with row scale
    aux_add = jnp.asarray(aux_add_np)
    sq_dev_cols = None  # phase B gets candidate ‖v‖² from the host gather

    queries = rng.standard_normal((q, d)).astype(np.float32)
    qp_np = 2.0 * queries  # prepare_queries("l2")
    queries_dev = jnp.asarray(queries)

    # --- phase A: int8 scan + selection + int8 narrowing (one dispatch) ----
    @functools.partial(jax.jit, static_argnames=("w_",))
    def phase_a(v8_, ams_, add_, qp_f32, q8, inv_sq, w_):
        bm = topk2.bucket_scores_scan_int8(q8, v8_, ams_, add_, inv_sq, bucket)
        bidx = jnp.sort(topk2.topk_buckets(bm, kp), axis=-1)  # [Q, kp]
        cand8 = v8_.reshape(nb, bucket, d)[bidx]  # [Q, kp, bucket, D] int8
        # narrowing score: fp32 query x dequantized row + EXACT -||v||^2 —
        # the only remaining error is the row-side quantization residual
        s = jnp.einsum(
            "qd,qkbd->qkb", qp_f32, cand8.astype(jnp.float32),
            preferred_element_type=jnp.float32,
        )
        rows = bidx[:, :, None] * bucket + jnp.arange(bucket, dtype=jnp.int32)
        rows = rows.reshape(q, kp * bucket)
        s = s.reshape(q, kp * bucket) * jnp.take(ams_, rows) + jnp.take(add_, rows)
        top_s, pos = jax.lax.top_k(s, w_)
        return jnp.take_along_axis(rows, pos, axis=1)  # [Q, W] global row ids

    @functools.partial(jax.jit, static_argnames=("w_", "inner"))
    def phase_a_sustained(v8_, ams_, add_, q8b, w_, inner):
        def body(_, x):
            qp_f32, q8, inv_sq = x
            return None, phase_a(v8_, ams_, add_, qp_f32, q8, inv_sq, w_)

        _, out = jax.lax.scan(body, None, q8b)
        return out

    # --- phase B: exact fp32 rescore over the host-gathered window ---------
    @functools.partial(jax.jit, static_argnames=("k_",))
    def phase_b(queries_, cand, ids, sq_c, valid_c, k_):
        s = 2.0 * jnp.einsum(
            "qd,qwd->qw", queries_, cand,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ) - sq_c
        s = jnp.where(valid_c, s, topk2.NEG_INF)
        top_s, top_i = topk2.topk_values_min_id(s, ids, k_)
        dist = topk2.scores_to_distances(top_s, queries_, "l2")
        dist = jnp.where(top_s == topk2.NEG_INF, jnp.inf, dist)
        return dist, jnp.where(top_s == topk2.NEG_INF, -1, top_i)

    def q8_of(qp):
        sqq = np.maximum(np.abs(qp).max(axis=1) / 127.0, 1e-30)
        q8 = np.clip(np.round(qp / sqq[:, None]), -127, 127).astype(np.int8)
        return jnp.asarray(q8), jnp.asarray((1.0 / sqq).astype(np.float32))

    def e2e(qp, queries_):
        q8, inv_sq = q8_of(qp)
        win = np.asarray(phase_a(v8, ams, aux_add, jnp.asarray(qp), q8, inv_sq, w))  # [Q, W]
        cand = corpus_np[win]  # host gather, [Q, W, D] fp32
        return phase_b(
            queries_,
            jnp.asarray(cand),
            jnp.asarray(win),
            jnp.asarray(sq_np[win]),
            jnp.asarray(valid_np[win]),
            k,
        )

    # --- correctness: independent float64 host oracle ----------------------
    dist_dev, ids_dev = e2e(qp_np, queries_dev)
    dist_dev, ids_dev = np.asarray(dist_dev), np.asarray(ids_dev)

    best = np.full((q, 0), np.inf)
    best_ids = np.zeros((q, 0), np.int64)
    qq64 = queries.astype(np.float64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        sub = corpus_np[s:e][valid_np[s:e]].astype(np.float64)
        sub_ids = np.nonzero(valid_np[s:e])[0] + s
        d2 = (
            (qq64 * qq64).sum(1)[:, None]
            - 2.0 * qq64 @ sub.T
            + (sub * sub).sum(1)[None, :]
        )
        dd = np.sqrt(np.maximum(d2, 0.0))
        alld = np.concatenate([best, dd], axis=1)
        alli = np.concatenate([best_ids, np.broadcast_to(sub_ids, (q, len(sub_ids)))], axis=1)
        keep = min(256, alld.shape[1])
        part = np.argpartition(alld, keep - 1, axis=1)[:, :keep]
        best = np.take_along_axis(alld, part, axis=1)
        best_ids = np.take_along_axis(alli, part, axis=1)
    oracle_ids = np.empty((q, 100), np.int64)
    for i in range(q):
        order = np.lexsort((best_ids[i], best[i]))
        oracle_ids[i] = best_ids[i][order][:100]

    recall = float(np.mean([
        len(set(ids_dev[i, :100].tolist()) & set(oracle_ids[i].tolist())) / 100
        for i in range(q)
    ]))
    assert recall == 1.0, f"recall@100 = {recall} != 1.0"

    # --- timing -------------------------------------------------------------
    inner = 4
    qbs = rng.standard_normal((inner, q, d)).astype(np.float32)
    q8b = np.empty((inner, q, d), np.int8)
    invb = np.empty((inner, q), np.float32)
    for i in range(inner):
        a, b = q8_of(2.0 * qbs[i])
        q8b[i], invb[i] = np.asarray(a), np.asarray(b)
    xs = (jnp.asarray(2.0 * qbs), jnp.asarray(q8b), jnp.asarray(invb))

    t_scan = common.timeit(
        lambda: phase_a_sustained(v8, ams, aux_add, xs, w, inner),
        max(args.iters // 2, 2),
    ) / inner

    t_e2e_start = time.perf_counter()
    e2e_iters = max(args.iters // 2, 3)
    for i in range(e2e_iters):
        out = e2e(2.0 * qbs[i % inner], jnp.asarray(qbs[i % inner]))
    common.sync(out[0])
    t_e2e = (time.perf_counter() - t_e2e_start) / e2e_iters

    common.emit(
        "config2_fullscale_filtered_scan_rows_per_sec",
        n / t_scan,
        "rows/s/chip",
        n=n, d=d, k=k, selectivity=0.3, window=w,
        device_scan_seconds=round(t_scan, 5),
        int8_gbytes_per_s=round(n * d / t_scan / 1e9, 1),
        e2e_exact_rows_per_s=round(n / t_e2e, 1),
        e2e_seconds_per_batch8=round(t_e2e, 4),
        e2e_qps=round(q / t_e2e, 1),
        recall_at_100=recall,
        residency="int8 on chip (7.4 GB), fp32 host-resident",
    )




def main_engine(args) -> None:
    """Config 2 AT SPEC through the ENGINE (VERDICT r3 #1/#2): the
    catalog owns the table, the residency router picks int8-resident
    under FENIX_HBM_BUDGET, phase B rescores ON THE HOST — a Flight
    client issuing the same descriptor takes exactly this path."""
    import os
    import shutil
    import tempfile

    import pyarrow as pa

    from fenix_tpu import expr
    from fenix_tpu.engine import executor as ex
    from fenix_tpu.engine.session import DeviceCache
    from fenix_tpu.io import ingest, table
    from fenix_tpu.utils.metrics import GLOBAL as METRICS

    n = int(10_000_000 * min(args.scale, 1.0)) // 128 * 128 or 1280
    d, k, q = 768, 100, 8
    chunk = min(n, 524_288)
    rng = np.random.default_rng(0)
    tags = rng.integers(0, 10, n)

    # default budget: 1.15x the int8-solo residency at THIS scale, so
    # the router's 0.9 safety margin clears and the plan is INT8 at any
    # --scale (dual fp32 needs ~4.9x more, so it never sneaks back in).
    # At full scale this is ~9.0e9 — the budget of the measured chip
    # run (2026-08-21); the asserted mode below guards reruns.
    n_pad = (n + 16383) // 16384 * 16384
    os.environ.setdefault("FENIX_HBM_BUDGET", str(int(1.15 * n_pad * (d + 16))))

    keep_root = args.root is not None
    root = args.root or tempfile.mkdtemp(prefix="fenix_cfg2e_")
    try:
        if keep_root and os.path.exists(os.path.join(root, "sources", "c2.arrow")):
            pass  # reuse (restart scenario): table + any sidecar as-is
        else:
            # generate + ingest STREAMING (record batches): one pa.table
            # would hold a 7.7B-element FixedSizeList flat array, past
            # Arrow's 2^31 per-array limit, and 30 GB of transient RAM
            t0 = time.perf_counter()
            schema = pa.schema(
                {"id": pa.int64(), "tag": pa.int64(),
                 "vector": pa.list_(pa.float32(), d)}
            )

            def batches():
                for s in range(0, n, chunk):
                    e = min(s + chunk, n)
                    block = rng.standard_normal((e - s, d), dtype=np.float32)
                    yield pa.record_batch(
                        [
                            pa.array(np.arange(s, e)),
                            pa.array(tags[s:e].astype(np.int64)),
                            ingest.numpy_to_fixed_size_list(block, pa.float32()),
                        ],
                        schema=schema,
                    )

            table.make(root, "c2", pa.RecordBatchReader.from_batches(schema, batches()))
            print(f"# gen+ingest {n*d*4/1e9:.1f} GB in {time.perf_counter()-t0:.0f}s",
              flush=True)

        cache = DeviceCache(root, mesh=None)
        queries = rng.standard_normal((q, d)).astype(np.float32)
        filt = expr.field("tag") < 3  # 30% selectivity

        def req(target):
            return ex.SearchRequest(
                source="c2", column="vector", target=target, metric="l2",
                maxval=k, filter=filt,
                extra={"window": min(args.window, n)},
            )

        from fenix_tpu.engine import residency

        mode = residency.plan(cache, req(queries))
        print(f"# residency plan: {mode}", flush=True)

        t0 = time.perf_counter()
        out = ex.execute_search(cache, req(queries))  # cold: builds int8_solo
        t_cold = time.perf_counter() - t0
        assert METRICS.snapshot().get("search.residency_int8", 0) >= 1
        print(f"# cold (int8 build + compile + search): {t_cold:.1f}s", flush=True)

        ids_dev = np.asarray(out.column("id")).reshape(q, k)
        dist_dev = np.asarray(out.column(ex.DIST_COL)).reshape(q, k)

        # warm e2e timing
        iters = max(args.iters // 2, 5)
        t0 = time.perf_counter()
        for i in range(iters):
            qs = rng.standard_normal((q, d)).astype(np.float32)
            last = ex.execute_search(cache, req(qs))
        t_e2e = (time.perf_counter() - t0) / iters
        assert last.num_rows == q * k

        # recall@100 vs an independent float64 host oracle
        host = cache.host_matrix("c2", "vector")
        valid_np = tags < 3
        qq64 = queries.astype(np.float64)
        best = np.full((q, 0), np.inf)
        best_ids = np.zeros((q, 0), np.int64)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            sub = host[s:e][valid_np[s:e]].astype(np.float64)
            sub_ids = np.nonzero(valid_np[s:e])[0] + s
            d2 = (
                (qq64 * qq64).sum(1)[:, None]
                - 2.0 * qq64 @ sub.T
                + (sub * sub).sum(1)[None, :]
            )
            dd = np.sqrt(np.maximum(d2, 0.0))
            alld = np.concatenate([best, dd], axis=1)
            alli = np.concatenate(
                [best_ids, np.broadcast_to(sub_ids, (q, len(sub_ids)))], axis=1
            )
            keep = min(256, alld.shape[1])
            part = np.argpartition(alld, keep - 1, axis=1)[:, :keep]
            best = np.take_along_axis(alld, part, axis=1)
            best_ids = np.take_along_axis(alli, part, axis=1)
        recall = 0.0
        for i in range(q):
            order = np.lexsort((best_ids[i], best[i]))
            oracle = set(best_ids[i][order][:k].tolist())
            recall += len(oracle & set(ids_dev[i].tolist())) / k
        recall /= q
        assert recall == 1.0, f"recall@{k} = {recall} != 1.0"

        common.emit(
            "config2_engine_e2e_seconds_per_batch8",
            t_e2e,
            "s/batch",
            n=n, d=d, k=k, selectivity=0.3, window=min(args.window, n),
            e2e_qps=round(q / t_e2e, 2),
            e2e_rows_per_s=round(n / t_e2e, 1),
            recall_at_100=recall,
            residency_mode=mode,
            cold_build_seconds=round(t_cold, 1),
            route="executor (int8-resident + host fp32 rescore)",
        )
    finally:
        if not keep_root:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
