"""End-to-end serving over Arrow Flight gRPC: warm single-query latency
and batch-1024 throughput against a real server process.

The SERVER owns the GPU (spawned with the default backend); the CLIENT
(this process) imports fenix_tpu and so JAX, and holds itself to the
CPU before that import, so only one process reserves the card:

    python -m benchmarks.e2e_grpc [--scale 1.0]   # 1.0 -> 1M rows

Prints one JSON line: {"metric": "e2e_grpc", ...} with warm single
latency (ms) and batch-1024 QPS.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    # before fenix_tpu (and JAX) is imported: the client stays off the card
    os.environ["JAX_PLATFORMS"] = "cpu"
    from benchmarks import common

    p = common.parser("e2e gRPC serving")
    args = p.parse_args()

    import pyarrow as pa

    import fenix_tpu
    from fenix_tpu.io import ingest

    n = int(1_048_576 * min(args.scale, 8.0)) // 16384 * 16384 or 16384
    d, k, qb = 128, 10, 1024
    rng = np.random.default_rng(0)

    root = tempfile.mkdtemp(prefix="fenix_e2e_")
    port = _free_port()
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    env.pop("JAX_PLATFORMS", None)  # the server gets the default backend
    log = open(os.path.join(root, "server.log"), "w")
    server = subprocess.Popen(
        [sys.executable, "-m", "fenix_tpu.launch", root,
         "--host", "127.0.0.1", "--port", str(port)],
        env=env, stdout=log, stderr=subprocess.STDOUT,
    )
    try:
        client = fenix_tpu.Flight(host="127.0.0.1", port=port)
        deadline = time.time() + 120
        while True:
            if server.poll() is not None:  # crashed at startup: fail fast
                raise RuntimeError(
                    f"server exited rc={server.returncode}; see "
                    f"{os.path.join(root, 'server.log')}"
                )
            try:
                client.health()
                break
            except Exception:
                if time.time() > deadline:
                    raise RuntimeError(
                        "server did not come up; see "
                        f"{os.path.join(root, 'server.log')}"
                    )
                time.sleep(1.0)

        vecs = common.make_corpus(n, d)
        client.make_table(
            "bench/items",
            pa.table(
                {
                    "id": pa.array(np.arange(n)),
                    "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
                }
            ).to_reader(),
        )

        q1 = rng.standard_normal(d).astype(np.float32)
        qbig = rng.standard_normal((qb, d)).astype(np.float32)
        # warm both jit shapes (first compile is minutes on a cold chip)
        client.search(q1, "bench/items", "vector", metric="cosine", maxval=k)
        client.search(qbig, "bench/items", "vector", metric="cosine", maxval=k)

        iters = max(args.iters, 10)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = client.search(q1, "bench/items", "vector", metric="cosine", maxval=k)
        single_ms = (time.perf_counter() - t0) / iters * 1e3
        assert out.num_rows == k

        bat_iters = max(args.iters // 2, 5)
        t0 = time.perf_counter()
        for _ in range(bat_iters):
            out = client.search(qbig, "bench/items", "vector", metric="cosine", maxval=k)
        batch_s = (time.perf_counter() - t0) / bat_iters
        assert out.num_rows == qb * k

        print(
            json.dumps(
                {
                    "metric": "e2e_grpc",
                    "value": round(qb / batch_s, 1),
                    "unit": "queries/s",
                    "extra": {
                        "n": n,
                        "d": d,
                        "warm_single_ms": round(single_ms, 2),
                        "batch1024_seconds": round(batch_s, 5),
                        "batch1024_qps": round(qb / batch_s, 1),
                    },
                }
            )
        )
    finally:
        server.terminate()
        try:
            server.wait(timeout=20)
        except subprocess.TimeoutExpired:
            server.kill()
        log.close()


if __name__ == "__main__":
    main()
