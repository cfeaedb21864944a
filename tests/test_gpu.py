"""Tests that need an NVIDIA GPU: ``FENIX_TESTS_GPU=1 pytest -m gpu``.

CPU tests cannot catch what only the card does: the fused phase-1
kernel compiled through Triton (the CPU runs it in interpret mode),
TF32 in default-precision f32 dots, and device transfers of packed
results. Each test takes the ``gpu`` fixture, which skips unless JAX's
backend is a GPU. Keep this suite small: every jit compiles afresh.
"""

import numpy as np
import pytest

from tests import test_topk_adversarial as adversarial

pytestmark = pytest.mark.gpu


def test_packed_result_survives_gpu_transfer(gpu):
    import jax
    import jax.numpy as jnp

    from fenix_tpu.ops import topk2

    dist_np = np.array([[0.5, 1.5, 1e-38]], np.float32)
    dist = jnp.asarray(dist_np)
    ids = jnp.asarray(np.array([[7, 70, 2_000_000_000]], np.int32))
    packed = jax.jit(topk2.pack_result)(dist, ids)
    d, i = topk2.unpack_result(packed)
    np.testing.assert_array_equal(i, [[7, 70, 2_000_000_000]])
    np.testing.assert_array_equal(d, dist_np)  # bit-exact fp32 round-trip


def test_executor_exact_search_on_gpu(gpu, tmp_path, rng):
    import pyarrow as pa

    from fenix_tpu.engine import executor
    from fenix_tpu.io import ingest, table

    root = str(tmp_path)
    vecs = rng.standard_normal((50_000, 64)).astype(np.float32)
    table.make(
        root,
        "t",
        pa.table(
            {
                "id": pa.array(np.arange(50_000)),
                "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
            }
        ).to_reader(),
    )
    cache = executor.get_cache(root)
    q = rng.standard_normal(64).astype(np.float32)
    res = executor.execute_search(
        cache,
        executor.SearchRequest(source="t", column="vector", target=q, metric="l2", maxval=5),
    )
    want = np.argsort(np.sqrt(((vecs - q) ** 2).sum(1)), kind="stable")[:5]
    np.testing.assert_array_equal(np.asarray(res.column("id")), want)


def test_executor_distances_fp32_true_on_gpu(gpu, tmp_path, rng):
    """Returned distances must match the numpy oracle to fp32 reduction
    order — the rescore runs with Precision.HIGHEST (the default would
    run the dot in TF32 and show ~1e-3 relative error)."""
    import pyarrow as pa

    from fenix_tpu.engine import executor
    from fenix_tpu.io import ingest, table

    root = str(tmp_path)
    vecs = rng.standard_normal((20_000, 128)).astype(np.float32)
    table.make(
        root, "t",
        pa.table({
            "id": pa.array(np.arange(20_000)),
            "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
        }).to_reader(),
    )
    cache = executor.get_cache(root)

    # Q=128 takes the fused phase-1 kernel and the fine rescore bucket
    q = rng.standard_normal((128, 128)).astype(np.float32)
    res = executor.execute_search(
        cache,
        executor.SearchRequest(source="t", column="vector", target=q, metric="l2", maxval=5),
    )
    ids = np.asarray(res.column("id")).reshape(128, 5)
    dists = np.asarray(res.column("__DISTANCE__")).reshape(128, 5)

    full = np.sqrt(((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1))
    want = np.argsort(full, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_allclose(
        dists, np.take_along_axis(full, ids, axis=1), rtol=2e-5, atol=2e-5
    )


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_kernel_matches_xla_at_real_width(gpu, dtype):
    """The compiled Triton-route kernel at Q=1024, D=768 against XLA's
    true-fp32 bucket maxima over the same (rounded) inputs."""
    import jax
    import jax.numpy as jnp

    from fenix_tpu.ops import topk2

    n, d, q, bucket = 1 << 17, 768, 1024, topk2.BUCKET_LARGE_Q
    corpus = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    queries = jax.random.normal(jax.random.PRNGKey(1), (q, d), jnp.float32)
    aux_mul, aux_add = topk2.prepare_aux(corpus, None, "l2")
    qp = topk2.prepare_queries(queries, "l2")
    if dtype == "int8":
        v8, sv = topk2.quantize_corpus_int8(corpus)
        q8, inv_sq = topk2.quantize_queries_int8(qp)
        got = topk2.bucket_scores_triton(
            q8, v8, aux_mul * sv, aux_add, inv_sq=inv_sq, bucket=bucket)
        s = jax.lax.dot_general(q8, v8, (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.int32).astype(jnp.float32)
        s = s * (aux_mul * sv)[None] + aux_add[None] * inv_sq[:, None]
        want = s.reshape(q, n // bucket, bucket).max(-1)
        tol = 1e-6
    else:
        cast = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        qc, cc = qp.astype(cast).astype(jnp.float32), corpus.astype(cast).astype(jnp.float32)
        got = topk2.bucket_scores_triton(
            qp.astype(cast), corpus.astype(cast), aux_mul, aux_add, bucket=bucket)
        want = topk2.bucket_scores_xla(qc, cc, aux_mul, aux_add, bucket)  # HIGHEST
        tol = 1e-5
    got, want = np.asarray(got).T, np.asarray(want)
    assert got.shape == (q, n // bucket)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("kp", [8, 16, 24])
@pytest.mark.parametrize("n", [1 << 15, 1 << 20])
def test_nbq_selection_on_kernel_output(gpu, rng, n, kp):
    """Bucket selection straight off the compiled kernel's [nb, Q]
    output, flat (small nb) and hierarchical, at the small k that XLA
    serves with its dedicated top-k kernel."""
    import jax
    import jax.numpy as jnp

    from fenix_tpu.ops import topk2

    d, q, bucket = 128, 128, topk2.BUCKET_LARGE_Q
    corpus = jax.random.normal(jax.random.PRNGKey(2), (n, d), jnp.float32)
    mask = jnp.arange(n) < n - n // 3  # −inf tail, like padded rows
    aux_mul, aux_add = topk2.prepare_aux(corpus, mask, "l2")
    qp = topk2.prepare_queries(jnp.asarray(rng.standard_normal((q, d)), jnp.float32), "l2")

    @jax.jit
    def run(qp, corpus, aux_mul, aux_add):
        bm = topk2.bucket_scores_triton(qp, corpus, aux_mul, aux_add, bucket=bucket)
        return bm, topk2.topk_buckets_nbq(bm, kp)

    bm, got = run(qp, corpus, aux_mul, aux_add)
    want = np.argsort(-np.asarray(bm).T, axis=1, kind="stable")[:, :kp]
    np.testing.assert_array_equal(np.sort(np.asarray(got), 1), np.sort(want, 1))


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("scan", ["fp32", "bf16", "int8"])
def test_tied_mass_at_k_boundary_on_gpu(gpu, rng, metric, scan):
    adversarial.test_tied_mass_at_k_boundary(rng, metric, scan)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("q", [4, 256])
def test_near_tied_maxima_against_bucket_order_on_gpu(gpu, rng, metric, q):
    adversarial.test_near_tied_maxima_against_bucket_order(rng, metric, q)
