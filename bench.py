"""Benchmark: exact kNN scan rate on one GPU (BASELINE.md config 1).

Workload: exact top-10 cosine kNN over N×128-dim fp32 vectors through
the engine's two-phase search (fenix_tpu.ops.topk2), on the first
visible device, which must be a GPU listed in ``HBM_BW``.

- headline: sustained scan rate at 8M×128 — ``lax.scan`` over 16
  distinct Q=8 query batches inside one jit, so the fixed cost of a
  dispatch is paid once; ``vs_baseline`` is the fraction of the card's
  published HBM bandwidth that the corpus read reaches.
- also measured: 1M×128 sustained and per dispatch, batch-1024 per
  dispatch in fp32 and with the bf16 and int8 scan copies.

Prints the card's name and power limit first (``nvidia-smi``), then one
JSON line with every number it measured. Run from the repo root:

    python bench.py
"""

from __future__ import annotations

import functools
import json
import subprocess
import time

import numpy as np

# Published HBM bandwidth (bytes/s) keyed by JAX ``device_kind``.
# Source: NVIDIA H100 SXM data sheet (80 GB HBM3, 3.35 TB/s).
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bw(device) -> float:
    """Published bandwidth of ``device``; an unlisted device is an error."""
    kind = getattr(device, "device_kind", None)
    if kind not in HBM_BW:
        raise KeyError(f"no published HBM bandwidth for device_kind {kind!r}")
    return HBM_BW[kind]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> None:
    import jax
    import jax.numpy as jnp

    from benchmarks.common import device_normal
    from fenix_tpu.ops import topk2
    from fenix_tpu.utils.jax_cache import configure_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit("bench.py measures the GPU; no GPU found")
    configure_compile_cache()
    dev = jax.devices()[0]
    roofline = hbm_bw(dev)
    print(card_line(), flush=True)

    d, k_pad = 128, 16  # canonical: k→16 (top-10 padded)
    n1, n8 = 1 << 20, 8 << 20
    rng = np.random.default_rng(0)

    @functools.partial(jax.jit, static_argnames=("k",))
    def sustained(corpus_, qbatches, mul, add, k, scan_int8=None):
        """One dispatch, many scans: lax.scan over [I, Q, D] batches."""

        def body(_, q):
            return None, topk2.topk_two_phase(
                corpus_, q, mul, add, k=k, metric="cosine", corpus_scan_int8=scan_int8
            )

        _, (dist, ids) = jax.lax.scan(body, None, qbatches, unroll=4)
        return dist, ids

    def timed_sustained(q, inner, iters, corpus_, mul, add, scan_int8=None) -> float:
        qb = jnp.asarray(rng.standard_normal((inner, q, d)).astype(np.float32))
        jax.block_until_ready(sustained(corpus_, qb, mul, add, k_pad, scan_int8))
        start = time.perf_counter()
        for _ in range(iters):
            out = sustained(corpus_, qb, mul, add, k_pad, scan_int8)
        jax.block_until_ready(out)
        return (time.perf_counter() - start) / (iters * inner)

    corpus1 = device_normal(n1, d, seed=0)
    am1, aa1 = topk2.prepare_aux(corpus1, None, "cosine")
    corpus8 = device_normal(n8, d, seed=7)
    am8, aa8 = topk2.prepare_aux(corpus8, None, "cosine")

    def timed_dispatch(q: int, iters: int, **kw) -> float:
        queries = jnp.asarray(rng.standard_normal((q, d)).astype(np.float32))
        jax.block_until_ready(
            topk2.topk_two_phase(corpus1, queries, am1, aa1, k=k_pad, metric="cosine", **kw)
        )
        start = time.perf_counter()
        for _ in range(iters):
            out = topk2.topk_two_phase(
                corpus1, queries, am1, aa1, k=k_pad, metric="cosine", **kw
            )
        jax.block_until_ready(out)
        return (time.perf_counter() - start) / iters

    # headline: sustained scan rate, 8M Q=8, median of three repeats
    t_runs = sorted(
        timed_sustained(q=8, inner=16, iters=4, corpus_=corpus8, mul=am8, add=aa8)
        for _ in range(3)
    )
    t_scan8 = t_runs[1]
    t_scan1 = timed_sustained(q=8, inner=64, iters=4, corpus_=corpus1, mul=am1, add=aa1)
    t_disp = timed_dispatch(q=8, iters=20)
    t_batch = timed_dispatch(q=1024, iters=10)
    t_batch_bf16 = timed_dispatch(
        q=1024, iters=10, corpus_scan=corpus1.astype(jnp.bfloat16)
    )
    t_batch_int8 = timed_dispatch(
        q=1024, iters=10, corpus_scan_int8=topk2.quantize_corpus_int8(corpus1)
    )

    print(json.dumps({
        "metric": "scan_rows_per_sec_8Mx128_cosine_top10",
        "value": n8 / t_scan8,
        "unit": "rows/s",
        "vs_baseline": n8 * d * 4 / t_scan8 / roofline,
        "vs_baseline_band": [n8 * d * 4 / t / roofline for t in (t_runs[-1], t_runs[0])],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "hbm_peak_bytes_per_s": roofline,
        "scan_seconds_8M": t_scan8,
        "scan_seconds_1M": t_scan1,
        "scan_rows_per_s_1M": n1 / t_scan1,
        "scan_rows_per_s_per_dispatch_1M": n1 / t_disp,
        "qps_batch1024": 1024 / t_batch,
        "qps_batch1024_bf16scan": 1024 / t_batch_bf16,
        "qps_batch1024_int8scan": 1024 / t_batch_int8,
    }))


if __name__ == "__main__":
    main()
