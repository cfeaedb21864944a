"""Adversarial near-tie corpora pin the BUCKET_PAD selection margin.

topk2 phase-1 scores are not bit-exact (3xTF32 in the fused GPU
kernel, a different reduction order in XLA's dots) — correctness rests
on the BUCKET_PAD candidate window plus the deterministic tie rule. ADVICE r2 asked for that assumption to be
PINNED on corpora engineered to stress it, not argued in a comment:

- exact duplicates tied across many more buckets than the candidate
  window, with the k-th boundary falling INSIDE the tied mass (any k
  of the tied rows are score-equal — the contract demands the smallest
  ids, which live in the earliest buckets; stable selection must keep
  them);
- near-tied bucket maxima spaced just above the documented phase-1
  error bound, permuted so the TRUE ranking runs *against* bucket
  order (a selector that collapses the ties keeps the earliest buckets
  and provably loses the true top-k — the failure ADVICE hypothesized).

Oracle: float64 brute force with the engine tie contract (ascending
distance, ties → ascending row id). The suite runs on whatever backend
pytest is on — on the GPU (tests/test_gpu.py re-runs it there) it
exercises the compiled kernel's selection, and on the CPU it pins the
tie contract + margin mechanics.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fenix_tpu.ops import topk2

N, D = 16_384, 32  # 128 coarse buckets / 512 fine buckets


def _oracle(queries: np.ndarray, corpus: np.ndarray, metric: str, k: int):
    """float64 distances, ascending, ties by ascending row id."""
    from tests import oracles

    dist = oracles.distance(queries.astype(np.float64), corpus.astype(np.float64), metric)
    order = np.argsort(dist, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(dist, order, axis=-1), order


def _tied_levels_corpus(rng, metric: str):
    """Corpus with two score LEVELS made of exact duplicate rows,
    scattered so the tied mass at the k-boundary spans far more buckets
    than the kp window. Exact ties survive any scan precision
    (identical inputs give identical scores in fp32, bf16, and per-row
    int8 alike); levels are separated from each other AND from the
    distractor mass by margins far above bf16/int8 resolution, so only
    the *tie handling* is under test, never near-tie recall (the bf16/
    int8 modes are approximate by contract on near-ties)."""
    corpus = rng.standard_normal((N, D)).astype(np.float32) * 0.05
    query = rng.standard_normal(D).astype(np.float32)
    query /= np.linalg.norm(query)
    w = rng.standard_normal(D).astype(np.float32)
    w -= (w @ query) * query
    w /= np.linalg.norm(w)

    # level 0: 4 duplicates closest to the query; level 1: 300
    # duplicates next — the k=16 boundary falls inside this tied mass.
    if metric == "l2":
        lvl0, lvl1 = query * 1.05, query * 1.3  # dist 0.05 / 0.3 vs ~1 noise
    elif metric == "dot":
        lvl0, lvl1 = query * 2.0, query * 1.5  # dot 2 / 1.5 vs ≲0.4 noise
    else:  # cosine — levels differ in ANGLE (scale is invariant)
        lvl0, lvl1 = query + 0.1 * w, query + 0.5 * w
    ids0 = rng.choice(N, size=4, replace=False)
    remaining = np.setdiff1d(np.arange(N), ids0)
    ids1 = rng.choice(remaining, size=300, replace=False)
    corpus[ids0] = lvl0.astype(np.float32)
    corpus[ids1] = lvl1.astype(np.float32)
    return corpus, query


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("scan", ["fp32", "bf16", "int8"])
def test_tied_mass_at_k_boundary(rng, metric, scan):
    corpus, query = _tied_levels_corpus(rng, metric)
    k = 16
    queries = query[None, :]

    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, metric)
    kw = {}
    if scan == "bf16":
        kw["corpus_scan"] = jnp.asarray(corpus, jnp.bfloat16)
    elif scan == "int8":
        kw["corpus_scan_int8"] = topk2.quantize_corpus_int8(jnp.asarray(corpus))
    dist, ids = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add,
        k=k, metric=metric, **kw,
    )

    want_d, want_i = _oracle(queries, corpus, metric, k)
    np.testing.assert_array_equal(np.asarray(ids), want_i)
    np.testing.assert_allclose(np.asarray(dist), want_d, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("q", [4, 256])
def test_near_tied_maxima_against_bucket_order(rng, metric, q):
    """Bucket maxima spaced ~3e-6 relative (above the fp32-mode phase-1
    error bound; far below bf16 resolution) with the TRUE ranking
    permuted against bucket order — best rows in the LAST buckets. A
    selector that rounds these ties together keeps the earliest
    buckets and loses the true top-k; HIGH-grade selection plus the
    BUCKET_PAD margin must not. q=256 drives the large-Q lowering
    (the fused kernel on the GPU, the blocked scan on the CPU)."""
    u = rng.standard_normal(D).astype(np.float64)
    u /= np.linalg.norm(u)
    # distractor mass well below the planted rows
    corpus = (rng.standard_normal((N, D)) * 0.05).astype(np.float32)

    n_planted = 64  # one per 2 coarse buckets on average, scattered
    ids = np.sort(rng.choice(N, size=n_planted, replace=False))
    # rank r (0 = best) assigned to the r-th LARGEST id: true order is
    # the exact reverse of bucket order
    ranks = np.arange(n_planted)[::-1]
    scale = 2.0 * (1.0 - ranks * 3e-6)
    corpus[ids] = (scale[:, None] * u[None, :]).astype(np.float32)

    queries = np.tile((u * 1.0).astype(np.float32)[None, :], (q, 1))
    # make batched rows distinct but equivalent (scale > 0 keeps order)
    queries *= (1.0 + np.arange(q, dtype=np.float32)[:, None] * 1e-3)

    k = 16
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, metric)
    dist, got = topk2.topk_two_phase(
        jnp.asarray(corpus), jnp.asarray(queries), aux_mul, aux_add, k=k, metric=metric
    )

    want_d, want_i = _oracle(queries, corpus, metric, k)
    np.testing.assert_array_equal(np.asarray(got), want_i)
    # planted spacing is resolvable in fp32 — rescored distances track
    # the float64 oracle to fp32 rounding
    np.testing.assert_allclose(np.asarray(dist), want_d, rtol=1e-5, atol=1e-6)


def test_tied_mass_pallas_bigq_interpret(rng):
    """The large-Q fused phase 1 (Pallas, Triton route) + nbq selection
    on the tied-mass corpus, in interpret mode (Triton has no CPU
    lowering): the fused kernel's bucket maxima must drive the same
    stable earliest-bucket choice the XLA lowering makes."""
    corpus, query = _tied_levels_corpus(rng, "dot")
    k = 16
    q = 256
    queries = np.tile(query[None, :], (q, 1)).astype(np.float32)
    queries *= (1.0 + np.arange(q, dtype=np.float32)[:, None] * 1e-3)

    bucket = topk2.bucket_for(q, N)
    qp = topk2.prepare_queries(jnp.asarray(queries), "dot")
    aux_mul, aux_add = topk2.prepare_aux(jnp.asarray(corpus), None, "dot")
    bm = topk2.bucket_scores_triton(
        qp, jnp.asarray(corpus), aux_mul, aux_add,
        interpret=True, bucket=bucket,
    )
    sel = np.asarray(topk2.topk_buckets_nbq(bm, k + topk2.BUCKET_PAD))

    _, want_i = _oracle(queries, corpus, "dot", k)
    for row in range(q):
        want_buckets = set((want_i[row] // bucket).tolist())
        assert want_buckets <= set(sel[row].tolist())
