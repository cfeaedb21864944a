"""BASELINE config 3: kNN + device join to an attributes table + hash
aggregate over match groups, end-to-end through the engine."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pyarrow as pa

from benchmarks import common


def main() -> None:
    args = common.parser("kNN + join + aggregate").parse_args()

    from fenix_tpu.engine import analytics, executor
    from fenix_tpu.io import ingest, table

    n = int(1_000_000 * min(args.scale, 10.0)) // 1024 * 1024 or 1024
    n_attrs = int(10_000_000 * min(args.scale, 1.0)) or 10_000
    d, k = 128, 128
    rng = np.random.default_rng(0)

    root = tempfile.mkdtemp(prefix="fenix_bench3_")
    vecs = common.make_corpus(n, d)
    table.make(
        root,
        "vec",
        pa.table(
            {
                "id": pa.array(np.arange(n)),
                "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
            }
        ).to_reader(),
    )
    attr_keys = rng.permutation(max(n_attrs, n))[:n_attrs]
    table.make(
        root,
        "attrs",
        pa.table(
            {
                "key": pa.array(attr_keys.astype(np.int64)),
                "grp": pa.array((attr_keys % 100).astype(np.int64)),
                "weight": pa.array(rng.standard_normal(n_attrs)),
            }
        ).to_reader(),
    )

    cache = executor.get_cache(root)
    target = rng.standard_normal(d).astype(np.float32)
    spec_join = analytics.JoinSpec(source="attrs", right_on="key")
    spec_agg = analytics.AggregateSpec(group_by="grp", value="weight", agg="sum", max_groups=128)

    def run():
        req = executor.SearchRequest(
            source="vec", column="vector", target=target, metric="cosine", maxval=k
        )
        return analytics.execute_search_join(cache, req, spec_join, spec_agg)

    run()  # warmup/compile
    import time

    start = time.perf_counter()
    for _ in range(args.iters):
        out = run()
    elapsed = (time.perf_counter() - start) / args.iters

    # sustained: chain the SAME fused device pipeline over a stream of
    # targets inside one dispatch — the per-dispatch number above
    # includes the host round trip, this exposes the device rate of
    # search→join→aggregate
    import functools

    import jax
    import jax.numpy as jnp

    from fenix_tpu.ops import distance as distance_ops

    metric = distance_ops.canonical_metric("cosine")
    data, corpus, _ = cache.snapshot("vec", "vector")
    left_col = cache.scalar("vec", "id")
    aux_mul, aux_add = cache.metric_aux("vec", "vector", metric)
    sorted_keys, sorted_index, attr_rows = cache.sorted_key("attrs", "key")
    group_col = cache.scalar("attrs", "grp")
    value_col = cache.scalar("attrs", "weight")
    q_pad = executor._canonical_q(1)
    k_pad = min(executor._canonical_k(k), corpus.rows_padded)

    statics = dict(
        k_pad=k_pad,
        metric=metric,
        agg=spec_agg.agg,
        max_groups=spec_agg.max_groups,
        use_value_col=True,
        use_dist=False,
    )

    @functools.partial(jax.jit, static_argnames=tuple(statics))
    def sustained(corpus_, qb, mul, add, lcol, skeys, sidx, arows, gcol, vcol, **st):
        def body(_, queries):
            return None, analytics._fused_search_join_aggregate(
                corpus_, queries, mul, add, jnp.int32(1), jnp.int32(k),
                lcol, skeys, sidx, arows, gcol, vcol, **st,
            )

        _, outs = jax.lax.scan(body, None, qb)
        return outs

    inner = 8
    targets = np.random.default_rng(1).standard_normal((inner, q_pad, d)).astype(np.float32)
    targets[:, 1:] = 0.0
    qb = jnp.asarray(targets)

    def run_sustained():
        return sustained(
            corpus.data, qb, aux_mul, aux_add,
            left_col.data.astype(jnp.int32), sorted_keys, sorted_index,
            attr_rows, group_col.data, value_col.data, **statics,
        )

    t_sust = common.timeit(run_sustained, max(args.iters, 4)) / inner

    common.emit(
        "search_join_aggregate_qps",
        1.0 / t_sust,
        "queries/s",
        n_vectors=n,
        n_attrs=n_attrs,
        k=k,
        groups=out.num_rows,
        seconds=round(t_sust, 5),
        per_dispatch_qps=round(1.0 / elapsed, 1),
    )


if __name__ == "__main__":
    main()
