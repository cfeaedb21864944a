"""Probed (IVF) search at HOST scale: 100M×128 on one chip's host
(VERDICT r4 #1 'done' criterion).

Brute streaming at this scale — the BASELINE headline row count —
moves the whole corpus to the device per search. The cell-sorted
host int8 layout (session.host_clustered_int8) turns the probed scan
into O(probed rows) of contiguous host reads: probe cells rank on the
host, phase-A int8 scores select a top-window candidate set, and the
shared exact fp32 rescore finishes. No device dispatch at all — the
residency router serves this table's probed traffic from the host
while the device handles resident tables.

Protocol (stages are idempotent against --root, so an interrupted run
never repeats the 51 GB ingest):
    FENIX_HBM_BUDGET=8.5e9 python -m benchmarks.ivf_host_scale --root <dir>
    # --scale 0.001 for a CPU smoke (JAX_PLATFORMS=cpu)
    # --flight: also measure through a spawned Flight server
    #   (do_exchange over the wire; client stays in this process)

recall@10/@100 are measured vs a float64 host oracle.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

from benchmarks import common


def main() -> None:
    p = common.parser("probed IVF at host scale (100M×128)")
    p.add_argument("--rows", type=int, default=100_000_000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--cells", type=int, default=4096, help="total composite cells")
    p.add_argument(
        "--books", type=int, default=2,
        help="product-coder codebooks; more books = finer factorization "
        "(a 2-book coder collapses a hierarchical corpus into few fat "
        "cells — 1710/16384 occupied with an 856k-row max at 100M; "
        "4x16 books spread the same cell count far thinner)",
    )
    p.add_argument(
        "--centers", type=int, default=16384,
        help="mixture modes in the synthetic corpus. Must exceed --cells "
        "by a healthy factor: the occupied-cell count is capped by the "
        "number of distinct modes (a 256-mode corpus filled 164/4096 "
        "cells with a 9M-row max cell — probed gathers were corpus-scale "
        "and the benchmark measured skew, not IVF)",
    )
    p.add_argument("--sample", type=int, default=1_000_000, help="coder training sample rows")
    p.add_argument("--root", default=None, help="persistent root (stages resume)")
    p.add_argument("--flight", action="store_true",
                   help="also measure through a spawned Flight server")
    p.add_argument("--port", type=int, default=9317)
    args = p.parse_args()

    import pyarrow as pa

    from fenix_tpu import coder, expr, index
    from fenix_tpu.engine import executor as ex
    from fenix_tpu.engine import residency
    from fenix_tpu.engine.session import DeviceCache
    from fenix_tpu.io import ingest, table

    n = int(args.rows * min(args.scale, 1.0)) // 128 * 128 or 1280
    d = args.dim
    q, k = 8, 100
    n_centers = args.centers  # mixture structure so IVF has geometry to exploit
    kbook = int(round(args.cells ** (1.0 / args.books)))
    cfg: coder.Config = {
        "metric": "l2", "codebook_size": kbook, "num_codebooks": args.books,
        "batch_size": 1024, "num_epochs": 2,
    }
    sample_rows = min(args.sample, n)
    chunk = min(n, 524_288)
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.standard_normal((n_centers, d)).astype(np.float32)

    import tempfile

    keep_root = args.root is not None
    root = args.root or tempfile.mkdtemp(prefix="fenix_ivf_")
    timings = {}
    try:
        # -- stage 1: corpus (mixture of gaussians), streamed ingest ------
        if not os.path.exists(table.path_of(root, "big")):
            t0 = time.perf_counter()
            schema = pa.schema({"id": pa.int64(), "vector": pa.list_(pa.float32(), d)})

            def batches():
                for s in range(0, n, chunk):
                    e = min(s + chunk, n)
                    which = rng.integers(0, n_centers, e - s)
                    block = centers[which] + rng.standard_normal(
                        (e - s, d), dtype=np.float32
                    )
                    yield pa.record_batch(
                        [pa.array(np.arange(s, e)),
                         ingest.numpy_to_fixed_size_list(block, pa.float32())],
                        schema=schema,
                    )

            table.make(root, "big", pa.RecordBatchReader.from_batches(schema, batches()))
            timings["gen_ingest_s"] = round(time.perf_counter() - t0, 1)
            print(f"# gen+ingest {n*d*4/1e9:.1f} GB: {timings['gen_ingest_s']}s",
                  flush=True)

        cache = DeviceCache(root, mesh=None)
        host = cache.host_matrix("big", "vector")
        assert host.shape == (n, d), (host.shape, n, d)

        # -- stage 2: coder trained on a host sample ----------------------
        if not os.path.exists(coder.path_of(root, "ivf")):
            t0 = time.perf_counter()
            sel = np.sort(rng.choice(n, sample_rows, replace=False))
            from fenix_tpu import native

            sample = native.gather_rows(host, sel.astype(np.int64))
            table.make(
                root, "sample",
                pa.table({
                    "id": pa.array(np.arange(sample_rows)),
                    "vector": ingest.numpy_to_fixed_size_list(sample, pa.float32()),
                }).to_reader(),
            )
            coder.make(root, "ivf", "sample", "vector", cfg, seed=0)
            timings["coder_train_s"] = round(time.perf_counter() - t0, 1)
            print(f"# coder (sampled {sample_rows}): {timings['coder_train_s']}s",
                  flush=True)

        # -- stage 3: host assignment + index -----------------------------
        if not os.path.exists(index.path_of(root, "ivf", "big", "vector")):
            t0 = time.perf_counter()
            os.environ["FENIX_ASSIGN"] = "host"
            index.make(root, "ivf", "big", "vector")
            timings["host_assign_s"] = round(time.perf_counter() - t0, 1)
            print(f"# host assignment of {n} rows: {timings['host_assign_s']}s",
                  flush=True)

        # -- stage 4: mirrors (flat int8 sidecar + cell-sorted layout) ----
        t0 = time.perf_counter()
        cache.host_int8("big", "vector")
        timings["int8_mirror_s"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        _, _, _, offsets = cache.host_clustered_int8("ivf", "big", "vector")
        timings["clustered_layout_s"] = round(time.perf_counter() - t0, 1)
        occupancy = np.diff(offsets)
        print(f"# mirrors: int8 {timings['int8_mirror_s']}s, clustered "
              f"{timings['clustered_layout_s']}s; cells occupied "
              f"{int((occupancy > 0).sum())}/{occupancy.size}, "
              f"max {int(occupancy.max())} rows", flush=True)

        # -- stage 5: probed searches through the executor ----------------
        # fresh rng: query identity must not depend on which earlier
        # stages were cache-skipped (stages consume the shared rng), or
        # the stage-6 oracle cache below could never hit on a rerun
        q_rng = np.random.default_rng(20260821)
        which = q_rng.integers(0, n_centers, q)
        queries = (centers[which] + q_rng.standard_normal((q, d), dtype=np.float32))

        def req(probes, maxval=k):
            return ex.SearchRequest(
                source="big", column="vector", target=queries, metric="l2",
                maxval=maxval, coding="ivf", probes=probes,
            )

        mode = residency.plan(cache, req(64))
        print(f"# residency plan (non-probed route): {mode}", flush=True)
        if n == args.rows:
            assert mode in (residency.INT8, residency.STREAM), mode

        results = {}
        for probes in (16, 64, 256):
            out = ex.execute_search(cache, req(probes))  # warm layouts
            t0 = time.perf_counter()
            iters = max(2, args.iters // 2)
            for _ in range(iters):
                out = ex.execute_search(cache, req(probes))
            dt = (time.perf_counter() - t0) / iters
            # parse by query id — probed results with fewer than k
            # reachable rows drop the padding, so a flat reshape fails
            # at smoke scales
            qid = np.asarray(out.column("__QUERY_ID__"))
            flat = np.asarray(out.column("id"))
            ids = np.full((q, k), -1, np.int64)
            for qi in range(q):
                mine = flat[qid == qi][:k]
                ids[qi, : mine.size] = mine
            results[probes] = (dt, ids)
            probed_rows = int(
                occupancy[
                    np.unique(
                        ex._rank_cells(
                            queries, cache.coding("ivf"), "l2", probes
                        )
                    )
                ].sum()
            )
            print(f"# probes={probes}: {dt:.3f} s/batch-{q} "
                  f"(~{probed_rows} probed rows over the batch)", flush=True)

        # -- stage 6: exact float64 oracle + recall (cached per root:
        # the 51 GB f64 pass costs ~10 min and queries are
        # deterministic) --------------------------------------------------
        t0 = time.perf_counter()
        import hashlib

        okey = hashlib.sha1(
            queries.tobytes() + str((n, d)).encode()
        ).hexdigest()[:16]
        opath = os.path.join(root, f"oracle_{okey}.npz")
        cached = None
        if os.path.exists(opath):
            try:
                with np.load(opath) as z:
                    cached = (z["best"], z["best_ids"])
            except Exception:
                cached = None
        qq64 = queries.astype(np.float64)
        best = np.full((q, 0), np.inf)
        best_ids = np.zeros((q, 0), np.int64)
        if cached is not None:
            best, best_ids = cached
        for s in range(0, n if cached is None else 0, chunk):
            e = min(s + chunk, n)
            sub = host[s:e].astype(np.float64)
            d2 = ((qq64 * qq64).sum(1)[:, None] - 2.0 * qq64 @ sub.T
                  + (sub * sub).sum(1)[None, :])
            dd = np.sqrt(np.maximum(d2, 0.0))
            alld = np.concatenate([best, dd], axis=1)
            alli = np.concatenate(
                [best_ids, np.broadcast_to(np.arange(s, e), (q, e - s))], axis=1
            )
            keep = min(256, alld.shape[1])
            part = np.argpartition(alld, keep - 1, axis=1)[:, :keep]
            best = np.take_along_axis(alld, part, axis=1)
            best_ids = np.take_along_axis(alli, part, axis=1)
        if cached is None and keep_root:
            tmp = opath + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, best=best, best_ids=best_ids)
            os.replace(tmp, opath)
        timings["oracle_s"] = round(time.perf_counter() - t0, 1)

        def recall(ids, at):
            r = 0.0
            for i in range(q):
                order = np.lexsort((best_ids[i], best[i]))
                r += len(set(best_ids[i][order][:at].tolist())
                         & set(ids[i][:at].tolist())) / at
            return round(r / q, 4)

        rec = {
            probes: {"recall_at_10": recall(ids, 10), "recall_at_100": recall(ids, k)}
            for probes, (dt, ids) in results.items()
        }
        print(f"# recalls vs float64 oracle: {rec}", flush=True)

        # -- stage 7 (optional): through a Flight server ------------------
        flight = {}
        if args.flight:
            env = dict(os.environ)
            env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
            srv = subprocess.Popen(
                [sys.executable, "-m", "fenix_tpu.launch", root,
                 "--host", "127.0.0.1", "--port", str(args.port)],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
            try:
                import fenix_tpu

                client = fenix_tpu.Flight(host="127.0.0.1", port=args.port)
                for _ in range(120):
                    try:
                        client.health()
                        break
                    except Exception:
                        time.sleep(1.0)
                for probes in (64,):
                    out = client.search(
                        queries, "big", "vector", metric="l2", maxval=k,
                        coding="ivf", probes=probes,
                    )  # warm (server-side mirrors load from the sidecars)
                    t0 = time.perf_counter()
                    iters = max(2, args.iters // 2)
                    for _ in range(iters):
                        out = client.search(
                            queries, "big", "vector", metric="l2", maxval=k,
                            coding="ivf", probes=probes,
                        )
                    flight[f"flight_s_per_batch8_probes{probes}"] = round(
                        (time.perf_counter() - t0) / iters, 3
                    )
                    qid_f = np.asarray(out.column("__QUERY_ID__"))
                    flat_f = np.asarray(out.column("id"))
                    ids = np.full((q, k), -1, np.int64)
                    for qi in range(q):
                        mine = flat_f[qid_f == qi][:k]
                        ids[qi, : mine.size] = mine
                    flight[f"flight_recall_at_10_probes{probes}"] = recall(ids, 10)
            finally:
                srv.terminate()
                srv.wait(timeout=30)
            print(f"# flight leg: {flight}", flush=True)

        dt64 = results[64][0]
        per_probe_seconds = {
            f"seconds_per_batch8_probes{p}": round(dt, 3)
            for p, (dt, _) in results.items()
        }
        common.emit(
            f"ivf_host_{n}x{d}_seconds_per_batch8_probes64", dt64, "s/batch",
            rows=n, dim=d, cells=int(kbook) ** args.books, books=args.books, k=k,
            **per_probe_seconds,
            **{f"probes{p}": r for p, r in rec.items()},
            vs_round4_brute_stream="679.5 s/batch-8 at 100M×128 (BENCH_r04)",
            timings=timings, **flight,
        )
    finally:
        if not keep_root:
            import shutil

            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
