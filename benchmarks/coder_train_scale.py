"""Coder (k-means) training at config-2 scale (VERDICT r3 #4).

Chip leg: streaming multi-codebook training over a 10M×768 HOST corpus
(ops.kmeans.train_streaming — the path coder.make routes to past the
HBM budget, pinned in tests/test_coder_index.py): rows/s, epoch wall.
The reference trains the same loop on CPU from a memory-mapped file
(coder.py:94-127) — this measures the accelerator rewrite at a scale
the reference's own tests never reach (100k rows).

Mesh leg (--mesh-curve, CPU): train_sharded epoch time at 1/2/4/8
virtual devices over 1M×128 — the data-parallel efficiency curve
(per-step Lloyd statistics psum over the mesh).

    python -m benchmarks.coder_train_scale
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -m benchmarks.coder_train_scale --mesh-curve
"""

from __future__ import annotations

import time

import numpy as np

from benchmarks import common


def main() -> None:
    p = common.parser("coder training at scale")
    p.add_argument("--mesh-curve", action="store_true")
    p.add_argument("--device-steps", action="store_true")
    p.add_argument("--books", type=int, default=2)
    p.add_argument("--k", type=int, default=256)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument(
        "--precision", default="fp32", choices=["fp32", "bf16", "int8"],
        help="chunk transport (VERDICT r4 next #5): int8 streams "
        "per-row-quantized codes+scales (4x fewer bytes; the r4 fp32 "
        "epoch was 99.95%% transfer), dequantized in-kernel, Lloyd "
        "math fp32. The quantize itself is timed separately — in "
        "production it is the session's per-revision sidecar mirror, "
        "shared with the search path, not a per-epoch cost.",
    )
    args = p.parse_args()
    if args.mesh_curve:
        return mesh_curve()
    if args.device_steps:
        return device_steps(args)

    from fenix_tpu.ops import kmeans

    n = int(10_000_000 * min(args.scale, 1.0)) // 128 * 128 or 12800
    d = 768
    chunk = min(n, 524_288)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    corpus = np.empty((n, d), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        corpus[s:e] = rng.standard_normal((e - s, d), dtype=np.float32)
    print(f"# gen {corpus.nbytes/1e9:.1f} GB in {time.perf_counter()-t0:.0f}s",
          flush=True)

    mirror = None
    quantize_s = 0.0
    if args.precision == "int8":
        from fenix_tpu.ops import topk2

        t0 = time.perf_counter()
        codes = np.empty((n, d), np.int8)
        scales = np.empty(n, np.float32)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            codes[s:e], scales[s:e] = topk2.quantize_rows_int8_np(corpus[s:e])
        quantize_s = time.perf_counter() - t0
        mirror = (codes, scales)
        print(f"# int8 mirror (once per revision, shared with serving): "
              f"{quantize_s:.0f}s", flush=True)

    t0 = time.perf_counter()
    cbs = kmeans.train_streaming(
        corpus, 0,
        num_codebooks=args.books, codebook_size=args.k,
        batch_size=args.batch, num_epochs=1, metric="l2",
        precision=args.precision, int8_mirror=mirror,
    )
    cbs_np = np.asarray(cbs)
    epoch_s = time.perf_counter() - t0
    assert np.isfinite(cbs_np).all()

    rows_per_step = args.books * args.batch
    steps = n // rows_per_step
    rows_consumed = steps * rows_per_step
    per_row = {"fp32": 4 * d, "bf16": 2 * d, "int8": d + 4}[args.precision]
    common.emit(
        f"coder_train_rows_per_sec_10Mx768_{args.precision}",
        rows_consumed / epoch_s,
        "rows/s",
        n=n, d=d, num_codebooks=args.books, codebook_size=args.k,
        batch_size=args.batch, steps=steps, precision=args.precision,
        epoch_seconds=round(epoch_s, 1),
        mirror_quantize_seconds=round(quantize_s, 1),
        host_to_device_gbytes=round(rows_consumed * per_row / 1e9, 1),
        route="train_streaming (host corpus, double-buffered chunks)",
    )


def device_steps(args) -> None:
    """Device-only Lloyd step rate at the 768-d config-2 shape: one
    resident [steps, books, batch, D] chunk, scanned — attributes the
    full-epoch wall (host-to-device transfer included) vs the actual
    device training rate."""
    import functools as ft
    import json

    import jax
    import jax.numpy as jnp

    from fenix_tpu.ops import kmeans

    d = 768
    steps = 128
    rng = np.random.default_rng(0)
    chunk = jnp.asarray(
        rng.standard_normal((steps, args.books, args.batch, d)).astype(np.float32)
    )
    cbs = jnp.asarray(
        rng.standard_normal((args.books, args.k, d)).astype(np.float32)
    )

    @ft.partial(jax.jit, static_argnames=("metric_",))
    def run_chunk(cbs_, chunk_, metric_):
        def step(c, sample):
            return (
                jax.vmap(kmeans.lloyd_step_single, in_axes=(0, 0, None))(
                    c, sample, metric_
                ),
                None,
            )

        out, _ = jax.lax.scan(step, cbs_, chunk_)
        return out

    np.asarray(run_chunk(cbs, chunk, "l2"))  # compile
    t0 = time.perf_counter()
    iters = 5
    for _ in range(iters):
        out = run_chunk(cbs, chunk, "l2")
    np.asarray(out)
    per_step = (time.perf_counter() - t0) / (iters * steps)
    rows_per_step = args.books * args.batch
    print(json.dumps({
        "device_ms_per_step": round(per_step * 1e3, 3),
        "device_rows_per_s": round(rows_per_step / per_step, 1),
        "epoch_device_seconds_at_10M": round(per_step * (10_000_000 // rows_per_step), 1),
    }), flush=True)


def mesh_curve() -> None:
    import jax

    from fenix_tpu.ops import kmeans
    from fenix_tpu.parallel import mesh as mesh_mod
    from fenix_tpu.parallel import search as psearch

    n, d = 1_048_576, 128
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((n, d)).astype(np.float32)

    import json

    for n_dev in (1, 2, 4, 8):
        if n_dev == 1:
            import jax.numpy as jnp

            corpus_dev = jnp.asarray(corpus)
            t0 = time.perf_counter()
            out = kmeans.train(
                corpus_dev, 0, num_codebooks=2, codebook_size=64,
                batch_size=512, num_epochs=1, metric="l2",
            )
            np.asarray(out)
            warm = None
            # second run = compiled
            t0 = time.perf_counter()
            out = kmeans.train(
                corpus_dev, 1, num_codebooks=2, codebook_size=64,
                batch_size=512, num_epochs=1, metric="l2",
            )
            np.asarray(out)
            warm = time.perf_counter() - t0
        else:
            mesh = mesh_mod.make_mesh(devices=jax.devices()[:n_dev])
            corpus_dev, _ = psearch.shard_corpus(mesh, corpus, block=1024)
            run = lambda seed: np.asarray(
                kmeans.train_sharded(
                    mesh, corpus_dev, n, seed, num_codebooks=2,
                    codebook_size=64, batch_size=512, num_epochs=1, metric="l2",
                )
            )
            run(0)  # compile
            t0 = time.perf_counter()
            run(1)
            warm = time.perf_counter() - t0
        print(json.dumps({"devices": n_dev, "epoch_s": round(warm, 2),
                          "rows_per_s": round(n / warm, 1)}), flush=True)


if __name__ == "__main__":
    main()
