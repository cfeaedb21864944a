"""BASELINE config 2: exact top-100 L2 over 10M×768 with a scalar
filter pushed below the distance kernel.

Full size needs ~30 GB fp32; ``--scale`` shrinks rows to fit the chip
(default 0.2 → 2M×768 ≈ 6 GB)."""

from __future__ import annotations

import numpy as np

from benchmarks import common


def main() -> None:
    args = common.parser("filtered L2 top-100").parse_args()

    import jax.numpy as jnp

    from fenix_tpu.ops import topk2

    n = int(10_000_000 * min(args.scale, 1.0) // 131072 * 131072) or 131072
    d, k = 768, 128  # top-100 canonicalized to 128
    rng = np.random.default_rng(0)

    import functools

    import jax

    corpus = jnp.asarray(common.make_corpus(n, d))
    tags = rng.integers(0, 10, n)
    mask = jnp.asarray(tags < 3)  # 30% selectivity scalar predicate
    aux_mul, aux_add = topk2.prepare_aux(corpus, mask, "l2")
    queries = jnp.asarray(rng.standard_normal((8, d)).astype(np.float32))

    t_disp = common.timeit(
        lambda: topk2.topk_two_phase(
            corpus, queries, aux_mul, aux_add, k=k, metric="l2"
        ),
        args.iters,
    )

    # sustained: chain scans inside one dispatch, so the fixed cost of
    # a lone jit call is paid once
    @functools.partial(jax.jit, static_argnames=("k_",))
    def sustained(corpus_, qb, mul, add, k_):
        def body(_, qs):
            return None, topk2.topk_two_phase(corpus_, qs, mul, add, k=k_, metric="l2")

        _, out = jax.lax.scan(body, None, qb)
        return out

    inner = 8
    qb = jnp.asarray(rng.standard_normal((inner, 8, d)).astype(np.float32))
    t = common.timeit(
        lambda: sustained(corpus, qb, aux_mul, aux_add, k), max(args.iters // 2, 2)
    ) / inner

    # int8 scan copy + exact fp32 rescore (quarter scan traffic; the
    # returned distances are exact — only bucket selection sees
    # quantization, guarded by the widened candidate margin). d=768
    # keeps the f32-accumulated int8 dot bit-exact (127²·768 < 2²⁴).
    v8, sv = topk2.quantize_corpus_int8(corpus)

    @functools.partial(jax.jit, static_argnames=("k_",))
    def sustained_int8(corpus_, qb_, mul, add, vv, ss, k_):
        def body(_, qs):
            return None, topk2.topk_two_phase(
                corpus_, qs, mul, add, k=k_, metric="l2", corpus_scan_int8=(vv, ss)
            )

        _, out = jax.lax.scan(body, None, qb_)
        return out

    t8 = common.timeit(
        lambda: sustained_int8(corpus, qb, aux_mul, aux_add, v8, sv, k),
        max(args.iters // 2, 2),
    ) / inner

    # recall@100 of the int8-selected ids vs the exact fp32 scan (batch 0)
    _, ids_f = sustained(corpus, qb, aux_mul, aux_add, k)
    _, ids_8 = sustained_int8(corpus, qb, aux_mul, aux_add, v8, sv, k)
    a, b = np.asarray(ids_f[0])[:, :100], np.asarray(ids_8[0])[:, :100]
    recall = float(np.mean([len(set(x) & set(y)) / 100 for x, y in zip(a, b)]))

    common.emit(
        "filtered_scan_rows_per_sec",
        n / t,
        "rows/s/chip",
        n=n,
        d=d,
        k=k,
        selectivity=0.3,
        seconds=round(t, 5),
        gbytes_per_s=round(n * d * 4 / t / 1e9, 1),
        per_dispatch_rows_per_s=round(n / t_disp, 1),
        int8_rows_per_s=round(n / t8, 1),
        int8_recall_at_100=round(recall, 4),
    )


if __name__ == "__main__":
    main()
