"""Two-phase exact top-k vs oracles; the fused Pallas (Triton-route)
phase-1 kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fenix_tpu.ops import topk2
from fenix_tpu.ops.distance import NEG_INF
from tests import oracles

METRICS = ["cosine", "dot", "inner_product", "l2", "euclidean"]


def build(rng, n, d, q):
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    return corpus, queries


@pytest.mark.parametrize("metric", METRICS)
def test_two_phase_matches_bruteforce(rng, metric):
    n, d, q, k = 4096, 32, 5, 10
    corpus, queries = build(rng, n, d, q)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, metric)

    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add, k=k, metric=metric
    )

    want_d, want_i = oracles.topk(oracles.distance(queries, corpus, metric), k)
    np.testing.assert_array_equal(np.asarray(ids), want_i)
    np.testing.assert_allclose(np.asarray(dist), want_d, rtol=1e-4, atol=1e-5)


def test_two_phase_respects_mask(rng):
    n, d, k = 2048, 16, 8
    corpus, queries = build(rng, n, d, 3)
    mask = rng.random(n) < 0.2
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), jnp.asarray(mask), "l2")

    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add, k=k, metric="l2"
    )
    ids = np.asarray(ids)
    allowed = set(np.flatnonzero(mask).tolist())
    for row in ids:
        for i in row:
            assert i == -1 or int(i) in allowed

    cand = np.flatnonzero(mask)
    want_d, want_i = oracles.topk(oracles.distance(queries, corpus[mask], "l2"), k)
    np.testing.assert_array_equal(ids, cand[want_i])


def test_two_phase_large_q_chunking(rng):
    n, d, q, k = 2048, 16, 100, 5  # q not a multiple of 64 → padding path
    corpus, queries = build(rng, n, d, q)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "cosine")

    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add, k=k, metric="cosine"
    )
    want_d, want_i = oracles.topk(oracles.distance(queries, corpus, "cosine"), k)
    np.testing.assert_array_equal(np.asarray(ids), want_i)


def test_two_phase_fewer_valid_than_k(rng):
    n, d = 1024, 16
    corpus, queries = build(rng, n, d, 2)
    mask = np.zeros(n, dtype=bool)
    mask[:3] = True
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), jnp.asarray(mask), "dot")

    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add, k=10, metric="dot"
    )
    ids = np.asarray(ids)
    assert ((ids >= 0).sum(axis=1) == 3).all()
    assert np.isinf(np.asarray(dist)[ids < 0]).all()


def test_blocked_scan_matches_oneshot_xla(rng, monkeypatch):
    """The blocked ``lax.scan`` phase 1 (XLA's form past the one-shot
    cap) must give the one-shot dot's bucket maxima."""
    n, d, qt = 4096, 64, 48
    corpus = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    queries = jnp.asarray(rng.standard_normal((qt, d)).astype(np.float32))
    aux_mul, aux_add = topk2.prepare_aux(corpus, None, "cosine")
    qp = topk2.prepare_queries(queries, "cosine")

    want = np.asarray(topk2.bucket_scores_xla(qp, corpus, aux_mul, aux_add))
    monkeypatch.setattr(topk2, "FUSABLE_TILE_BYTES", 4 * qt * 512)  # 8 steps
    assert topk2._fusable_block(n, qt) == 512
    got = np.asarray(topk2.bucket_scores_scan(qp, corpus, aux_mul, aux_add))

    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("q", [1, 5, 100])
def test_two_phase_probed_matches_scan(rng, q):
    n, d, k, n_cells, probes = 2048, 16, 8, 16, 4
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    coded = rng.integers(0, n_cells, n).astype(np.int32)
    cells = np.stack([rng.choice(n_cells, probes, replace=False) for _ in range(q)]).astype(np.int32)

    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "l2")
    dist, ids = topk2.topk_two_phase_probed(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add,
        jnp.asarray(coded), jnp.asarray(cells), k=k, metric="l2",
    )
    dist, ids = np.asarray(dist), np.asarray(ids)

    for qi in range(q):
        keep = np.isin(coded, cells[qi])
        cand = np.flatnonzero(keep)
        want_d, want_i = oracles.topk(
            oracles.distance(queries[qi:qi+1], corpus[keep], "l2"), k
        )
        got_valid = ids[qi] >= 0
        assert got_valid.sum() == min(k, keep.sum())
        np.testing.assert_array_equal(ids[qi][got_valid], cand[want_i[0][:got_valid.sum()]])
        np.testing.assert_allclose(dist[qi][got_valid], want_d[0][:got_valid.sum()],
                                   rtol=1e-4, atol=1e-5)


def test_two_phase_bf16_scan_high_recall(rng):
    n, d, q, k = 4096, 32, 8, 10
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "cosine")

    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add,
        k=k, metric="cosine",
        corpus_scan=jnp.asarray(corpus, dtype=jnp.bfloat16),
    )
    _, want_i = oracles.topk(oracles.distance(queries, corpus, "cosine"), k)

    # recall@k over the batch must be near-perfect; distances are fp32-exact
    recall = np.mean([
        len(set(ids[i].tolist()) & set(want_i[i].tolist())) / k for i in range(q)
    ])
    assert recall >= 0.95
    # distances of returned rows are the exact fp32 values
    got_ids = np.asarray(ids)
    exact = oracles.distance(queries, corpus, "cosine")
    for i in range(q):
        np.testing.assert_allclose(
            np.asarray(dist)[i], exact[i][got_ids[i]], rtol=1e-4, atol=1e-5
        )


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_two_phase_int8_scan_high_recall(rng, metric):
    n, d, q, k = 4096, 32, 8, 10
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, metric)

    v8, sv = topk2.quantize_corpus_int8(jnp.asarray(corpus))
    assert v8.dtype == jnp.int8 and sv.shape == (n,)

    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add,
        k=k, metric=metric,
        corpus_scan_int8=(v8, sv),
    )
    _, want_i = oracles.topk(oracles.distance(queries, corpus, metric), k)

    recall = np.mean([
        len(set(ids[i].tolist()) & set(want_i[i].tolist())) / k for i in range(q)
    ])
    assert recall >= 0.95
    # distances of returned rows are the exact fp32 values
    got_ids = np.asarray(ids)
    exact = oracles.distance(queries, corpus, metric)
    for i in range(q):
        np.testing.assert_allclose(
            np.asarray(dist)[i], exact[i][got_ids[i]], rtol=1e-4, atol=1e-5
        )


def test_int8_quantization_respects_filter_mask(rng):
    """-inf overlays in aux_add must survive the per-query 1/sq scaling."""
    n, d, q, k = 1024, 16, 4, 5
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    mask = rng.random(n) < 0.3
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), jnp.asarray(mask), "l2")
    v8, sv = topk2.quantize_corpus_int8(jnp.asarray(corpus))

    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add,
        k=k, metric="l2", corpus_scan_int8=(v8, sv),
    )
    ids = np.asarray(ids)
    allowed = set(np.flatnonzero(mask).tolist())
    for i in range(q):
        returned = set(ids[i][ids[i] >= 0].tolist())
        assert returned <= allowed


def test_bigq_pallas_matches_xla_interpret(rng):
    n, d, qt = 2048, 128, 512
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((qt, d)).astype(np.float32)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "l2")

    want = np.asarray(topk2.bucket_scores_xla(
        jnp.asarray(queries), jnp.asarray(corpus), aux_mul, aux_add))
    got = np.asarray(topk2.bucket_scores_triton(
        jnp.asarray(queries), jnp.asarray(corpus), aux_mul, aux_add, interpret=True))
    np.testing.assert_allclose(got.T, want, rtol=1e-5, atol=1e-5)


def test_bigq_pallas_int8_matches_reference_math(rng):
    n, d, qt = 2048, 128, 256
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((qt, d)).astype(np.float32)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "l2")

    v8, sv = topk2.quantize_corpus_int8(jnp.asarray(corpus))
    qp = topk2.prepare_queries(jnp.asarray(queries), "l2")
    q8, inv_sq = topk2.quantize_queries_int8(qp)

    want = np.asarray(topk2.bucket_scores_scan_int8(q8, v8, aux_mul * sv, aux_add, inv_sq))
    got = np.asarray(topk2.bucket_scores_triton(
        q8, v8, aux_mul * sv, aux_add, inv_sq=inv_sq, interpret=True))
    np.testing.assert_allclose(got.T, want, rtol=1e-5, atol=1e-5)


def test_bigq_pallas_nbq_selection_path_interpret(rng):
    """The production large-Q route on the GPU: the kernel's [nb, Q]
    output fed to topk_buckets_nbq must select the same buckets as the
    [Q, nb] API + topk_buckets."""
    n, d, qt, kp = 131072, 32, 256, 12  # nb = n/32 = 4096 → hierarchical
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((qt, d)).astype(np.float32)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "cosine")
    qp = topk2.prepare_queries(jnp.asarray(queries), "cosine")

    bm_nbq = topk2.bucket_scores_triton(
        qp, jnp.asarray(corpus), aux_mul, aux_add, interpret=True,
        bucket=topk2.BUCKET_LARGE_Q)
    bm_qnb = jnp.asarray(np.asarray(bm_nbq).T)

    got = np.sort(np.asarray(topk2.topk_buckets_nbq(bm_nbq, kp)), axis=1)
    want = np.sort(np.asarray(topk2.topk_buckets(bm_qnb, kp)), axis=1)
    np.testing.assert_array_equal(got, want)


def test_int8_f32_accumulation_is_exact(rng):
    """The int8 phase-1 dot accumulates in f32 when d <= 1024: every
    partial sum is an integer bounded by 127^2*d < 2^24, exactly
    representable in f32 — bitwise equal to i32 accumulation. (The f32
    form is what lets XLA fuse the bucket-max epilogue into the dot;
    benchmarks/exp_int8_fuse{,2}.py.)"""
    import jax

    for d in (128, 1024):
        q8 = jnp.asarray(rng.integers(-127, 128, (8, d)).astype(np.int8))
        v8 = jnp.asarray(rng.integers(-127, 128, (4096, d)).astype(np.int8))
        dn = (((1,), (1,)), ((), ()))
        s_f32 = jax.lax.dot_general(q8, v8, dn, preferred_element_type=jnp.float32)
        s_i32 = jax.lax.dot_general(q8, v8, dn, preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(
            np.asarray(s_f32), np.asarray(s_i32).astype(np.float32)
        )
        assert 127 * 127 * d < 2**24


def test_topk_buckets_hierarchical_matches_flat_with_ties(rng):
    """Hierarchical bucket selection must equal flat lax.top_k exactly,
    including stable tie order (small integer values force heavy ties)."""
    q, nb, kp = 16, 4096, 4  # nb > 2*kp*128 → hierarchical path
    bm = rng.integers(0, 7, (q, nb)).astype(np.float32)
    bm[0, :] = 3.0  # one row all-ties
    bm[1, -kp:] = 100.0  # winners at the very end
    got = np.asarray(topk2.topk_buckets(jnp.asarray(bm), kp))
    _, want = jax.lax.top_k(jnp.asarray(bm), kp)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_topk_buckets_flat_fallback(rng):
    q, nb, kp = 4, 256, 8  # too narrow → flat path
    bm = rng.standard_normal((q, nb)).astype(np.float32)
    got = np.asarray(topk2.topk_buckets(jnp.asarray(bm), kp))
    _, want = jax.lax.top_k(jnp.asarray(bm), kp)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_topk_buckets_nbq_matches_qnb(rng):
    """[nb, Q]-layout selection (transpose-free Pallas consumer) must
    pick the identical bucket sets as the [Q, nb] hierarchy, including
    under heavy ties (stable → smallest bucket id)."""
    q, nb, kp = 16, 4096, 4
    bm = rng.integers(0, 7, (q, nb)).astype(np.float32)
    bm[0, :] = 3.0
    bm[1, -kp:] = 100.0
    got = np.sort(np.asarray(topk2.topk_buckets_nbq(jnp.asarray(bm.T), kp)), axis=1)
    want = np.sort(np.asarray(topk2.topk_buckets(jnp.asarray(bm), kp)), axis=1)
    np.testing.assert_array_equal(got, want)
    # flat fallback (narrow) path too
    q2, nb2, kp2 = 4, 256, 8
    bm2 = rng.standard_normal((q2, nb2)).astype(np.float32)
    got2 = np.sort(np.asarray(topk2.topk_buckets_nbq(jnp.asarray(bm2.T), kp2)), axis=1)
    want2 = np.sort(np.asarray(topk2.topk_buckets(jnp.asarray(bm2), kp2)), axis=1)
    np.testing.assert_array_equal(got2, want2)
    # non-128-divisible nb exercises the NEG_INF row padding
    q3, nb3, kp3 = 8, 8 * 128 + 96, 4
    bm3 = rng.standard_normal((q3, nb3)).astype(np.float32)
    got3 = np.sort(np.asarray(topk2.topk_buckets_nbq(jnp.asarray(bm3.T), kp3)), axis=1)
    want3 = np.sort(np.asarray(topk2.topk_buckets(jnp.asarray(bm3), kp3)), axis=1)
    np.testing.assert_array_equal(got3, want3)


def test_two_phase_large_q_fine_bucket_exact(rng):
    """Q > 64 switches to the 32-row rescore bucket — still exact."""
    n, d, q, k = 2048, 16, 128, 7
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "l2")
    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add, k=k, metric="l2"
    )
    want_d, want_i = oracles.topk(oracles.distance(queries, corpus, "l2"), k)
    np.testing.assert_array_equal(np.asarray(ids), want_i)
    np.testing.assert_allclose(np.asarray(dist), want_d, rtol=1e-4, atol=1e-5)


def test_bigq_pallas_fine_bucket_interpret(rng):
    n, d, qt = 2048, 128, 256
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((qt, d)).astype(np.float32)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "cosine")
    want = np.asarray(topk2.bucket_scores_xla(
        jnp.asarray(queries), jnp.asarray(corpus), aux_mul, aux_add, 32))
    got = np.asarray(topk2.bucket_scores_triton(
        jnp.asarray(queries), jnp.asarray(corpus), aux_mul, aux_add,
        interpret=True, bucket=32))
    np.testing.assert_allclose(got.T, want, rtol=1e-5, atol=1e-5)


def test_topk_values_min_id_tie_contract(rng):
    """Iterated max+min-id selection must order by (score desc, id asc)
    regardless of candidate position — the clustered IVF layout's
    candidate order is (cell, row), not id."""
    c, w, k = 8, 512, 6
    s = rng.integers(0, 5, (c, w)).astype(np.float32)  # heavy ties
    ids = np.stack([rng.permutation(w).astype(np.int32) for _ in range(c)])
    ids[0, :10] = -1  # some invalid slots
    s[0, :10] = NEG_INF

    got_s, got_i = topk2.topk_values_min_id(jnp.asarray(s), jnp.asarray(ids), k)
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)

    for ci in range(c):
        valid = ids[ci] >= 0
        order = np.lexsort((ids[ci][valid], -s[ci][valid]))
        want_s = s[ci][valid][order][:k]
        want_i = ids[ci][valid][order][:k]
        np.testing.assert_array_equal(got_s[ci], want_s)
        np.testing.assert_array_equal(got_i[ci], want_i)


def test_midq_pad_to_bigq_matches_oracle(rng, monkeypatch):
    """32 < Q not a multiple of the kernel's query tile: the kernel pads
    the batch with zero queries and slices them off again. Every step is
    row-independent per query, so results must equal the oracle
    exactly. The CPU has no Triton lowering — force eligibility and run
    the kernel in interpret mode."""
    n, d, q, k = 2048, 64, 96, 10
    corpus, queries = build(rng, n, d, q)
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "l2")

    orig_kernel = topk2.bucket_scores_triton
    calls = []
    monkeypatch.setattr(topk2, "_bigq_eligible", lambda n: True)
    monkeypatch.setattr(
        topk2,
        "bucket_scores_triton",
        lambda *a, **kw: calls.append(a[0].shape) or orig_kernel(*a, interpret=True, **kw),
    )
    # jit caches by traced shapes; these (n, d, q) are unique to this
    # test so the patched globals are what get traced
    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add, k=k, metric="l2"
    )

    assert calls == [(q, d)]
    assert ids.shape == (q, k)
    want_d, want_i = oracles.topk(oracles.distance(queries, corpus, "l2"), k)
    np.testing.assert_array_equal(np.asarray(ids), want_i)
    np.testing.assert_allclose(np.asarray(dist), want_d, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("d,qt,bucket", [(100, 40, 128), (48, 200, 32)])
def test_triton_kernel_odd_width_and_padded_batch(rng, dtype, d, qt, bucket):
    """D not a multiple of the K chunk (masked tail chunk) and Q not a
    multiple of the query tile (zero-padded, sliced off) against the
    XLA forms, per scan dtype."""
    n = 1024
    corpus = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    queries = jnp.asarray(rng.standard_normal((qt, d)).astype(np.float32))
    aux_mul, aux_add = topk2.prepare_aux(corpus, None, "l2")
    qp = topk2.prepare_queries(queries, "l2")
    if dtype == "int8":
        v8, sv = topk2.quantize_corpus_int8(corpus)
        q8, inv_sq = topk2.quantize_queries_int8(qp)
        want = topk2.bucket_scores_scan_int8(q8, v8, aux_mul * sv, aux_add, inv_sq, bucket)
        got = topk2.bucket_scores_triton(
            q8, v8, aux_mul * sv, aux_add, inv_sq=inv_sq, interpret=True, bucket=bucket
        )
    else:
        cast = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        qc, cc = qp.astype(cast), corpus.astype(cast)
        # the kernel accumulates bf16 products in f32: the f32 one-shot
        # over the same rounded inputs is its reference
        want = topk2.bucket_scores_xla(
            qc.astype(jnp.float32), cc.astype(jnp.float32), aux_mul, aux_add, bucket
        )
        got = topk2.bucket_scores_triton(
            qc, cc, aux_mul, aux_add, interpret=True, bucket=bucket
        )
    assert got.shape == (n // bucket, qt)
    np.testing.assert_allclose(np.asarray(got).T, np.asarray(want), rtol=1e-5, atol=1e-4)


def test_phase1_route_by_platform(monkeypatch):
    """cpu → XLA, gpu → the fused kernel when rows tile, anything else
    → an error rather than a guess."""
    monkeypatch.setattr(topk2.jax, "default_backend", lambda: "cpu")
    assert not topk2._bigq_eligible(1 << 20)
    monkeypatch.setattr(topk2.jax, "default_backend", lambda: "gpu")
    assert topk2._bigq_eligible(1 << 20)
    assert not topk2._bigq_eligible(1000)  # rows do not tile: XLA
    monkeypatch.setattr(topk2.jax, "default_backend", lambda: "metal")
    with pytest.raises(NotImplementedError):
        topk2._bigq_eligible(1 << 20)
