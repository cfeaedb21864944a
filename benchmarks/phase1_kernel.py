"""Phase 1 on the card: the fused kernel against XLA's two plain forms.

Times, per (N, D, scan dtype, Q):

- ``kernel``: ``topk2.bucket_scores_triton`` (Pallas, Triton route);
- ``xla_oneshot``: one dot over the whole corpus, [N, Q] score tile in
  device memory (skipped where that tile would exceed 8 GB);
- ``xla_scan_8MB``: the blocked ``lax.scan`` at the default 8 MB step
  tile (a 64 MB tile measured no better on an H100);

then the whole two-phase search (``topk2.topk_two_phase``) with the
kernel route and with the XLA route, and one Flight batch-1024 search
through an in-process server, both routes. ``--tiles`` adds a sweep of
kernel tile shapes at 1M rows, Q=1024.

    python -m benchmarks.phase1_kernel [--dims 128,768] [--rows 1,8]
        [--qs 96,256,1024] [--tiles] [--no-flight] [--out FILE]

Every record is one JSON line on stdout (and in ``--out``); times are
milliseconds per call, fenced with ``block_until_ready``. Refuses to run
without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import threading
import time

import numpy as np

ONESHOT_TILE_CAP = 8 << 30


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def timed_ms(fn, budget_s: float = 1.0) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    est = time.perf_counter() - t0
    iters = int(min(20, max(3, budget_s / max(est, 1e-6))))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


@contextlib.contextmanager
def xla_route():
    """Trace with the fused kernel switched off (XLA forms only)."""
    from fenix_tpu.ops import topk2

    orig = topk2._bigq_eligible
    topk2._bigq_eligible = lambda n: False
    try:
        yield
    finally:
        topk2._bigq_eligible = orig


def phase1_forms(c, am, aa, qp, dtype, bucket):
    """({form: jitted callable}, its arguments) for one scan dtype."""
    import jax
    import jax.numpy as jnp

    from fenix_tpu.ops import topk2

    n, q = c.shape[0], qp.shape[0]

    if dtype == "int8":
        v8, sv = topk2.quantize_corpus_int8(c)
        q8, inv = topk2.quantize_queries_int8(qp)
        args = (q8, v8, am * sv, aa, inv)

        def kernel(q8, v8, m, a, inv):
            return topk2.bucket_scores_triton(q8, v8, m, a, inv_sq=inv, bucket=bucket)

        def oneshot(q8, v8, m, a, inv):
            s = jax.lax.dot_general(q8, v8, (((1,), (1,)), ((), ())),
                                    preferred_element_type=jnp.float32)
            s = s * m[None] + a[None] * inv[:, None]
            return s.reshape(q, n // bucket, bucket).max(-1)

        def scan(q8, v8, m, a, inv):
            return topk2.bucket_scores_scan_int8(q8, v8, m, a, inv, bucket)
    else:
        cc = c.astype(jnp.bfloat16) if dtype == "bf16" else c
        args = (qp.astype(cc.dtype), cc, am, aa)

        def kernel(qq, cc, m, a):
            return topk2.bucket_scores_triton(qq, cc, m, a, bucket=bucket)

        def oneshot(qq, cc, m, a):
            return topk2.bucket_scores_xla(qq, cc, m, a, bucket)

        def scan(qq, cc, m, a):
            return topk2.bucket_scores_scan(qq, cc, m, a, bucket)

    forms = {"kernel": jax.jit(kernel)}
    if n * q * 4 <= ONESHOT_TILE_CAP:
        forms["xla_oneshot"] = jax.jit(oneshot)
    forms["xla_scan_8MB"] = jax.jit(scan)
    return forms, args


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dims", default="128,768")
    p.add_argument("--rows", default="1,8", help="corpus sizes, in Mi rows")
    p.add_argument("--qs", default="96,256,1024")
    p.add_argument("--tiles", action="store_true", help="kernel tile sweep")
    p.add_argument("--no-flight", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax

    from benchmarks.common import device_normal
    from fenix_tpu.ops import topk2
    from fenix_tpu.utils.jax_cache import configure_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit("phase1_kernel measures the GPU; no GPU found")
    configure_compile_cache()
    dev = jax.devices()[0]
    out_f = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        rec = {"device": dev.device_kind, "card": CARD, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()

    CARD = card()
    print(CARD, flush=True)

    rows = [int(r) << 20 for r in args.rows.split(",")]
    qs = [int(q) for q in args.qs.split(",")]
    for d in (int(x) for x in args.dims.split(",")):
        for n in rows:
            c = device_normal(n, d, args.seed)
            n = c.shape[0]
            am, aa = topk2.prepare_aux(c, None, "cosine")
            if args.tiles and n == 1 << 20:
                tile_sweep(c, am, aa, d, emit, args.seed)
            for q in qs:
                queries = jax.random.normal(jax.random.PRNGKey(args.seed + 1), (q, d))
                qp = topk2.prepare_queries(queries, "cosine")
                bucket = topk2.bucket_for(q, n)
                for dtype in ("fp32", "bf16", "int8"):
                    forms, fargs = phase1_forms(c, am, aa, qp, dtype, bucket)
                    rec = {"what": "phase1", "n": n, "d": d, "q": q, "dtype": dtype}
                    for name, f in forms.items():
                        if name == "kernel":
                            rec[name] = timed_ms(lambda: f(*fargs))
                        else:
                            with xla_route():
                                rec[name] = timed_ms(lambda: f(*fargs))
                    rec.update(two_phase(c, am, aa, queries, dtype))
                    emit(rec)
                    del forms, fargs
            del c, am, aa
    if not args.no_flight:
        emit(flight_batch(args.seed))


def two_phase(c, am, aa, queries, dtype) -> dict:
    """The whole search, kernel route vs XLA route (k=16)."""
    import jax
    import jax.numpy as jnp

    from fenix_tpu.ops import topk2

    raw = topk2.topk_two_phase.__wrapped__
    scan = None
    if dtype == "bf16":
        scan = c.astype(jnp.bfloat16)
    elif dtype == "int8":
        scan = topk2.quantize_corpus_int8(c)

    def search(c, queries, am, aa, scan):  # scan copies ride as arguments
        kw = {"corpus_scan_int8" if dtype == "int8" else "corpus_scan": scan}
        return raw(c, queries, am, aa, k=16, metric="cosine", **kw)

    f_k, f_x = jax.jit(search), jax.jit(search)
    args = (c, queries, am, aa, scan)
    out = {"two_phase_kernel": timed_ms(lambda: f_k(*args))}
    ids_k = np.asarray(f_k(*args)[1])
    with xla_route():
        out["two_phase_xla"] = timed_ms(lambda: f_x(*args))
    ids_x = np.asarray(f_x(*args)[1])
    out["two_phase_ids_equal"] = bool((ids_k == ids_x).all())
    return out


def tile_sweep(c, am, aa, d, emit, seed) -> None:
    """Kernel tile shapes at Q=1024 (fp32/bf16/int8)."""
    import jax

    from fenix_tpu.ops import topk2

    saved = (topk2._TRITON_BN, topk2._TRITON_WARPS, topk2._TRITON_STAGES,
             dict(topk2._TRITON_BK))
    queries = jax.random.normal(jax.random.PRNGKey(seed + 1), (1024, d))
    qp = topk2.prepare_queries(queries, "cosine")
    n = c.shape[0]
    for bn, warps, stages, bk_scale in [
        (128, 4, 3, 1), (128, 8, 3, 1), (128, 8, 4, 1), (64, 4, 3, 1),
        (128, 4, 3, 2), (128, 8, 3, 2),
    ]:
        topk2._TRITON_BN, topk2._TRITON_WARPS, topk2._TRITON_STAGES = bn, warps, stages
        topk2._TRITON_BK.update({k: v * bk_scale for k, v in saved[3].items()})
        rec = {"what": "tiles", "n": n, "d": d, "q": 1024, "bn": bn, "warps": warps,
               "stages": stages, "bk": dict(topk2._TRITON_BK)}
        for dtype in ("fp32", "bf16", "int8"):
            forms, fargs = phase1_forms(c, am, aa, qp, dtype, 32)
            try:
                rec[dtype] = timed_ms(lambda: forms["kernel"](*fargs))
            except Exception as e:  # a shape the compiler refuses is a finding
                rec[dtype] = f"failed: {type(e).__name__}: {str(e)[:200]}"
        emit(rec)
    topk2._TRITON_BN, topk2._TRITON_WARPS, topk2._TRITON_STAGES = saved[:3]
    topk2._TRITON_BK.clear()
    topk2._TRITON_BK.update(saved[3])


def flight_batch(seed: int, n: int = 1 << 20) -> dict:
    """One batch-1024 search through a live Flight server (1M×128 fp32,
    cosine, top-10), kernel route vs XLA route, in this process."""
    import tempfile

    import jax
    import pyarrow as pa

    import fenix_tpu
    from fenix_tpu.io import ingest

    d, q = 128, 1024
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d), dtype=np.float32)
    queries = rng.standard_normal((q, d), dtype=np.float32)
    with tempfile.TemporaryDirectory() as root:
        server = fenix_tpu.Server(root, host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve, daemon=True)
        thread.start()
        try:
            client = fenix_tpu.Flight(host="127.0.0.1", port=server.port)
            client.make_table("bench/items", pa.table({
                "id": pa.array(np.arange(n)),
                "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
            }).to_reader())

            def search():
                return client.search(queries, "bench/items", "vector", "cosine", maxval=10)

            def wall_ms(iters=5):
                search()
                t0 = time.perf_counter()
                for _ in range(iters):
                    res = search()
                return (time.perf_counter() - t0) / iters * 1e3, res

            t_k, res_k = wall_ms()
            with xla_route():
                jax.clear_caches()
                t_x, res_x = wall_ms()
            jax.clear_caches()
            same = res_k.column("id").equals(res_x.column("id"))
            client.close()
        finally:
            server.shutdown()
    return {"what": "flight_batch1024", "n": n, "d": d, "q": q,
            "kernel_ms": t_k, "xla_ms": t_x, "ids_equal": bool(same)}


if __name__ == "__main__":
    main()
