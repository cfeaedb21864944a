"""Multi-codebook k-means (Lloyd) iteration, jit/vmap on device.

Semantics parity: /root/reference/src/fenix/io/coder/coder.py:53-65 —
one Lloyd step per batch: assign each sample to its nearest centroid,
then ``index_reduce(..., reduce="mean")`` with ``include_self=True``,
i.e. the new centroid is the mean of {old centroid} ∪ {assigned
samples}; cosine normalizes before and after. The reference vmaps the
step over codebooks (coder.py:95); here that is ``jax.vmap`` over the
leading codebook axis, which shards cleanly over a mesh axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fenix_tpu.ops.distance import canonical_metric, normalize, pairwise_distance


def lloyd_step_single(
    centroids: jax.Array,  # [K, D]
    batch: jax.Array,  # [B, D]
    metric: str,
) -> jax.Array:
    """One Lloyd step for a single codebook."""
    metric = canonical_metric(metric)

    if metric == "cosine":
        centroids = normalize(centroids)
        batch = normalize(batch)

    k = centroids.shape[0]
    dist = pairwise_distance(batch, centroids, metric)  # [B, K]
    assign = jnp.argmin(dist, axis=-1)  # [B]

    # mean over {old centroid} ∪ {assigned samples}  (include_self=True)
    sums = jax.ops.segment_sum(batch, assign, num_segments=k)  # [K, D]
    counts = jax.ops.segment_sum(
        jnp.ones((batch.shape[0],), dtype=jnp.float32), assign, num_segments=k
    )  # [K]
    centroids = (centroids + sums) / (1.0 + counts[:, None])

    if metric == "cosine":
        centroids = normalize(centroids)

    return centroids


@functools.partial(jax.jit, static_argnames=("metric",), donate_argnums=(0,))
def lloyd_step(
    codebooks: jax.Array,  # [n_codebooks, K, D]
    batch: jax.Array,  # [n_codebooks, B, D]
    metric: str,
) -> jax.Array:
    """Vmapped Lloyd step over the codebook axis (coder.py:95 parity)."""
    return jax.vmap(lloyd_step_single, in_axes=(0, 0, None))(codebooks, batch, metric)


@functools.partial(
    jax.jit, static_argnames=("num_codebooks", "codebook_size", "batch_size", "num_epochs", "metric")
)
def train(
    corpus: jax.Array,  # [N, D]
    seed: jax.Array,  # scalar uint32
    num_codebooks: int,
    codebook_size: int,
    batch_size: int,
    num_epochs: int,
    metric: str,
) -> jax.Array:
    """Full multi-codebook k-means training as ONE device computation.

    Reference semantics (coder.py:94-127): random-row init, then per
    epoch a fresh permutation consumed in ``num_codebooks·batch_size``
    batches, one vmapped Lloyd step each. Runs as nested ``lax.scan``s
    so the whole training is a single dispatch — the reference pays a
    host round-trip per batch (and this environment ~1.7 ms per
    dispatch, which dominated per-step training).
    """
    n_rows, dim = corpus.shape
    key = jax.random.PRNGKey(seed)

    key, init_key = jax.random.split(key)
    init_rows = jax.random.choice(init_key, n_rows, (codebook_size * num_codebooks,), replace=False)
    codebooks = jnp.take(corpus, init_rows, axis=0).reshape(
        num_codebooks, codebook_size, dim
    )

    rows_per_step = num_codebooks * batch_size
    steps = n_rows // rows_per_step

    def epoch(carry, epoch_key):
        cbs = carry
        perm = jax.random.permutation(epoch_key, n_rows)[: steps * rows_per_step]
        idx = perm.reshape(steps, num_codebooks, batch_size)

        def step(cbs, step_idx):
            sample = jnp.take(corpus, step_idx, axis=0)  # [n, b, D]
            cbs = jax.vmap(lloyd_step_single, in_axes=(0, 0, None))(cbs, sample, metric)
            return cbs, None

        cbs, _ = jax.lax.scan(step, cbs, idx)
        return cbs, None

    epoch_keys = jax.random.split(key, num_epochs)
    codebooks, _ = jax.lax.scan(epoch, codebooks, epoch_keys)
    return codebooks


def train_streaming(
    matrix,  # np.ndarray [N, D] fp32 HOST corpus
    seed: int,
    *,
    num_codebooks: int,
    codebook_size: int,
    batch_size: int,
    num_epochs: int,
    metric: str,
    chunk_rows: "int | None" = None,
    precision: str = "fp32",
    int8_mirror=None,  # optional precomputed (codes [N,D] int8, scales [N] f32)
) -> jax.Array:
    """Multi-codebook training over a HOST-resident corpus: the corpus
    never lands on device — permuted row chunks stream host→device
    double-buffered (io.batch.prefetch_to_device), each chunk running
    its Lloyd steps as one scanned dispatch while the next chunk's
    host gather + upload overlaps. Codebooks (the only persistent
    device state) carry across dispatches via donation.

    This is the coder-training leg of the residency story
    (engine/residency.py): reference coder.py:94-127 trains from a
    memory-mapped file on CPU at any corpus size; `train` above needs
    the fp32 corpus in HBM, which caps it at ~4M×768 on a 16 GB chip.
    Step math is IDENTICAL to :func:`train` (permutation → sequential
    ``num_codebooks·batch_size`` batches → vmapped include-self Lloyd
    step); the documented divergence is the permutation source (host
    numpy RNG instead of an in-jit threefry — a device permutation
    cannot index a host corpus), pinned against a hand-rolled
    per-step oracle in tests/test_coder_index.py.

    ``precision`` picks the CHUNK TRANSPORT (VERDICT r4 next #5 — the
    measured 10M×768 epoch was 99.95% transfer, 3072 s of which the
    device needed ~1.5 s, so transfer bytes ARE the epoch): "int8"
    streams per-row-quantized codes + scales (4× fewer bytes; the same
    symmetric quantizer the search path validated at recall@100 = 1.0)
    and dequantizes in-kernel before the fp32 Lloyd step — pass
    ``int8_mirror=(codes, scales)`` to reuse a prebuilt host mirror
    (session.host_int8), else the corpus quantizes once up front;
    "bf16" casts chunks to bfloat16 on the host (2× fewer bytes).
    Codebooks and all update math stay fp32 either way — only the
    SAMPLES carry quantization noise, bounded like the search phase-A
    (row-relative ≤ 1/254). The int8 path is pinned IDENTICAL to fp32
    streaming over the dequantized corpus (same seed → same
    permutation → same samples); centroid drift vs true-fp32 training
    is measured in tests/test_coder_index.py and
    benchmarks/coder_train_scale.py."""
    import numpy as np

    from fenix_tpu import native
    from fenix_tpu.io import batch as batch_io

    assert precision in ("fp32", "bf16", "int8"), precision
    n_rows, dim = matrix.shape
    rng = np.random.default_rng(seed)

    codes = scales = None
    if precision == "int8":
        from fenix_tpu.ops import topk2

        if int8_mirror is not None:
            codes, scales = int8_mirror
            if codes.shape != (n_rows, dim) or scales.shape[0] != n_rows:
                # mirror from a different table revision than `matrix`
                # (a mutation between the caller's load and the mirror
                # fetch): silently training on other rows' codes — or
                # an IndexError mid-epoch — is worse than re-quantizing
                codes = scales = int8_mirror = None
        if int8_mirror is None:
            codes = np.empty((n_rows, dim), np.int8)
            scales = np.empty(n_rows, np.float32)
            qchunk = max(1, (256 << 20) // (4 * dim))
            for s in range(0, n_rows, qchunk):
                e = min(s + qchunk, n_rows)
                codes[s:e], scales[s:e] = topk2.quantize_rows_int8_np(matrix[s:e])

    init_rows = rng.choice(n_rows, codebook_size * num_codebooks, replace=False)
    if precision == "int8":
        # init from the DEQUANTIZED rows — every sample the device sees
        # is dequantized, so the whole run is bit-pinnable against fp32
        # streaming over the dequantized corpus (the CPU test contract)
        ir = init_rows.astype(np.int64)
        init = np.asarray(codes[ir], np.float32) * np.asarray(scales[ir])[:, None]
        codebooks = jnp.asarray(init).reshape(num_codebooks, codebook_size, dim)
    else:
        codebooks = jnp.asarray(
            native.gather_rows(matrix, init_rows.astype(np.int64))
        ).reshape(num_codebooks, codebook_size, dim)

    rows_per_step = num_codebooks * batch_size
    steps_total = n_rows // rows_per_step
    if chunk_rows is None:
        # size chunks from the HBM budget like the streaming scan does
        # (round-4 review finding: a fixed 1M-row chunk is 6.4 GB at
        # d=1536 and prefetch keeps TWO in flight — RESOURCE_EXHAUSTED
        # in exactly the past-the-budget regime this path serves):
        # two in-flight chunks + codebooks must fit → ~1/4 each,
        # per-row bytes following the transport precision
        from fenix_tpu.utils import hbm

        budget = hbm.budget_bytes() or (2 << 30)
        per_row = {"fp32": 4 * dim, "bf16": 2 * dim, "int8": dim + 4}[precision]
        chunk_rows = min(1 << 20, max(int(0.9 * budget / 4 / per_row), 1))
    steps_per_chunk = max(1, chunk_rows // rows_per_step)

    @functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("metric_",))
    def run_chunk(cbs, chunk, metric_):
        # chunk [steps, num_codebooks, batch_size, D] fp32 or bf16 —
        # cast up BEFORE the Lloyd step so all update math stays fp32
        chunk = chunk.astype(jnp.float32)

        def step(cbs, sample):
            return (
                jax.vmap(lloyd_step_single, in_axes=(0, 0, None))(cbs, sample, metric_),
                None,
            )

        cbs, _ = jax.lax.scan(step, cbs, chunk)
        return cbs

    @functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("metric_",))
    def run_chunk_int8(cbs, chunk8, sv, metric_):
        # chunk8 [steps, nb, b, D] int8, sv [steps, nb, b] f32 per-row
        # scales — dequantize in-kernel, Lloyd math stays fp32
        def step(cbs, sample_sv):
            c8, s8 = sample_sv
            sample = c8.astype(jnp.float32) * s8[..., None]
            return (
                jax.vmap(lloyd_step_single, in_axes=(0, 0, None))(cbs, sample, metric_),
                None,
            )

        cbs, _ = jax.lax.scan(step, cbs, (chunk8, sv))
        return cbs

    def chunks():
        import ml_dtypes

        for _ in range(num_epochs):
            perm = rng.permutation(n_rows)[: steps_total * rows_per_step]
            for s0 in range(0, steps_total, steps_per_chunk):
                s1 = min(s0 + steps_per_chunk, steps_total)
                idx = perm[s0 * rows_per_step : s1 * rows_per_step].astype(np.int64)
                shape = (s1 - s0, num_codebooks, batch_size, dim)
                if precision == "int8":
                    yield (
                        np.ascontiguousarray(codes[idx]).reshape(shape),
                        np.ascontiguousarray(scales[idx]).reshape(shape[:-1]),
                    )
                elif precision == "bf16":
                    yield native.gather_rows(matrix, idx).reshape(shape).astype(
                        ml_dtypes.bfloat16
                    )
                else:
                    yield native.gather_rows(matrix, idx).reshape(shape)

    def put(item):
        if isinstance(item, tuple):
            return tuple(jnp.asarray(a) for a in item)
        return jax.device_put(item)

    for chunk_dev in batch_io.prefetch_to_device(chunks(), transform=put):
        if precision == "int8":
            codebooks = run_chunk_int8(codebooks, *chunk_dev, metric_=metric)
        else:
            codebooks = run_chunk(codebooks, chunk_dev, metric_=metric)
    return codebooks


def train_sharded(
    mesh: jax.sharding.Mesh,
    corpus: jax.Array,  # [N_pad, D] row-sharded over every mesh axis
    rows: int,  # valid rows (padding zeros sit at the global tail)
    seed,
    *,
    num_codebooks: int,
    codebook_size: int,
    batch_size: int,
    num_epochs: int,
    metric: str,
) -> jax.Array:
    """Mesh-sharded multi-codebook training as ONE device computation.

    Same structure as :func:`train` (random-row init, epochs of scanned
    Lloyd steps) but data-parallel over corpus rows: every shard samples
    batches from ITS OWN rows and contributes local assignment
    statistics; the segment sums/counts ``psum`` over the mesh, so each
    codebook update is numerically the single-device update on the
    union batch. Codebooks replicate.

    Documented divergence from ``train`` (and reference coder.py:106-118):
    batches sample per-shard WITH replacement instead of one global
    permutation — a global permutation would gather rows across the
    interconnect every step; per-shard sampling keeps training
    data-local, and the update math is unchanged. Each shard draws the
    same ``ceil(batch_size/S)`` samples (static shapes) but weights its
    statistics by the share of valid rows it holds, so the expected
    per-row contribution is uniform across shards and the total batch
    mass is ``batch_size`` even when padding leaves shards underfilled
    (small corpora) or a shard holds a handful of rows (which would
    otherwise be oversampled at full weight). Deterministic per
    (seed, mesh size).
    """
    from jax.sharding import PartitionSpec as P

    metric_c = canonical_metric(metric)
    axes = mesh.axis_names
    assert len(axes) == 2, f"expected a (data, model) mesh, got axes {axes}"
    n_shards = int(mesh.devices.size)
    n_pad, dim = corpus.shape
    rows_local = n_pad // n_shards
    b_local = -(-batch_size // n_shards)  # samples drawn per shard per step
    steps = max(rows // (num_codebooks * batch_size), 1)

    def lloyd_psum(centroids, batch, weight):
        if metric_c == "cosine":
            centroids = normalize(centroids)
            batch = normalize(batch)
        k = centroids.shape[0]
        dist = pairwise_distance(batch, centroids, metric_c)
        assign = jnp.argmin(dist, axis=-1)
        w = jnp.full((batch.shape[0],), weight, jnp.float32)
        sums = jax.ops.segment_sum(batch * w[:, None], assign, num_segments=k)
        counts = jax.ops.segment_sum(w, assign, num_segments=k)
        sums = jax.lax.psum(sums, axes)
        counts = jax.lax.psum(counts, axes)
        centroids = (centroids + sums) / (1.0 + counts[:, None])
        if metric_c == "cosine":
            centroids = normalize(centroids)
        return centroids

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axes, None), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(corpus_l, seed_arr):
        shard = jax.lax.axis_index(axes[0]) * jax.lax.axis_size(axes[1]) + (
            jax.lax.axis_index(axes[1])
        )
        start = shard * rows_local
        valid_l = jnp.clip(rows - start, 0, rows_local)
        # importance weight: this shard holds valid_l/rows of the data
        # but contributes b_local of the batch's samples → scale its
        # statistics so every row's expected mass is batch_size/rows
        # (empty shards weigh 0; near-empty shards can't dominate)
        sample_weight = (valid_l.astype(jnp.float32) / float(rows)) * (
            float(batch_size) / float(b_local)
        )

        key = jax.random.PRNGKey(seed_arr[0])
        key, init_key, sample_key = jax.random.split(key, 3)

        # init: the SAME global random rows on every shard (unfolded
        # key), assembled by ownership + psum — matches train()'s
        # replace=False row init
        init_rows = jax.random.choice(
            init_key, rows, (codebook_size * num_codebooks,), replace=False
        )
        lp = init_rows - start
        owned = (lp >= 0) & (lp < rows_local)
        contrib = jnp.where(
            owned[:, None], jnp.take(corpus_l, jnp.clip(lp, 0, rows_local - 1), axis=0), 0.0
        )
        codebooks = jax.lax.psum(contrib, axes).reshape(
            num_codebooks, codebook_size, dim
        )

        # sampling: distinct stream per shard, over local valid rows
        local_key = jax.random.fold_in(sample_key, shard)

        def epoch(cbs, ekey):
            def step(cbs, skey):
                idx = jax.random.randint(
                    skey, (num_codebooks, b_local), 0, jnp.maximum(valid_l, 1)
                )
                sample = jnp.take(corpus_l, idx.reshape(-1), axis=0).reshape(
                    num_codebooks, b_local, dim
                )
                cbs = jax.vmap(lloyd_psum, in_axes=(0, 0, None))(
                    cbs, sample, sample_weight
                )
                return cbs, None

            cbs, _ = jax.lax.scan(step, cbs, jax.random.split(ekey, steps))
            return cbs, None

        codebooks, _ = jax.lax.scan(
            epoch, codebooks, jax.random.split(local_key, num_epochs)
        )
        return codebooks

    return run(corpus, jnp.asarray([seed], dtype=jnp.uint32))


def sharded_lloyd_step(mesh: jax.sharding.Mesh, data_axis: str, model_axis: str | None, metric: str):
    """Build a pjit'd Lloyd step over a device mesh.

    Rows (the batch) shard over ``data_axis`` (data parallelism);
    codebooks optionally shard over ``model_axis`` (the tensor-parallel
    analog for this workload). Segment sums reduce over the data axis
    with an implicit ``psum`` inserted by XLA via sharding propagation.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    cb_spec = P(model_axis, None, None) if model_axis else P(None, None, None)
    batch_spec = P(model_axis, data_axis, None) if model_axis else P(None, data_axis, None)

    def step(codebooks, batch):
        return jax.vmap(lloyd_step_single, in_axes=(0, 0, None))(codebooks, batch, metric)

    return jax.jit(
        step,
        in_shardings=(NamedSharding(mesh, cb_spec), NamedSharding(mesh, batch_spec)),
        out_shardings=NamedSharding(mesh, cb_spec),
        donate_argnums=(0,),
    )
