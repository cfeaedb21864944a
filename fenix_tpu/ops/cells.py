"""Composite-cell scoring for the multi-codebook coder.

Semantics parity: /root/reference/src/fenix/io/coder/coder.py:143-194 —
each of the ``n`` codebooks quantizes the *full* vector; a composite
cell is one centroid choice per codebook; the cell score is the sum of
per-codebook distances; cell ids enumerate the cartesian product with
codebook 0 as the most-significant base-``k`` digit
(coder.py:171-181's repeat_interleave/repeat cross-product).

Accelerator-first: the score sum is separable, so
- nearest-cell **assignment** is n independent argmins (O(n·k·d) per
  row, never k^n — reference pays k^n even for assignment), and
- top-``m`` cells are found by scoring the k^n sums only when k^n is
  small, else by a bounded best-first expansion over per-codebook
  sorted distances (SURVEY.md §7 hard parts, last bullet).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fenix_tpu.ops.distance import canonical_metric, pairwise_distance

# k^n at or below this is scored by direct enumeration on device.
DENSE_CELL_LIMIT = 1 << 20

# Composite cell ids are int32 on device (jax x64 stays off); configs beyond this are rejected up front instead of silently
# wrapping (the reference's int64 ids make such configs "work", but
# 2^31 composite cells is far past any useful IVF geometry).
MAX_CELLS = (1 << 31) - 1


def check_cell_space(codebook_size: int, num_codebooks: int) -> None:
    if codebook_size**num_codebooks > MAX_CELLS:
        raise ValueError(
            f"codebook_size**num_codebooks = {codebook_size}**{num_codebooks} "
            f"exceeds the int32 composite-cell id space ({MAX_CELLS}); "
            "reduce codebook_size or num_codebooks"
        )


def codebook_distances(
    targets: jax.Array,  # [Q, D]
    codebooks: jax.Array,  # [n, K, D]
    metric: str,
) -> jax.Array:  # [Q, n, K]
    """Per-codebook distances, true fp32 (``HIGHEST``): on the GPU a
    default-precision dot runs in TF32, which would place rows near a
    cell boundary differently from the fp32 host twins below. K·n
    centroids make the extra cost negligible."""
    metric = canonical_metric(metric)
    n, k, d = codebooks.shape
    flat = codebooks.reshape(n * k, d)
    return pairwise_distance(
        targets, flat, metric, precision=jax.lax.Precision.HIGHEST
    ).reshape(-1, n, k)


@functools.partial(jax.jit, static_argnames=("metric",))
def assign_cells(
    vectors: jax.Array,  # [N, D]
    codebooks: jax.Array,  # [n, K, D]
    metric: str,
) -> jax.Array:  # [N] int32 composite cell id
    """Nearest composite cell via per-codebook argmin (sum-separable)."""
    n, k, _ = codebooks.shape
    dist = codebook_distances(vectors, codebooks, metric)  # [N, n, K]
    digits = jnp.argmin(dist, axis=-1).astype(jnp.int32)  # [N, n]
    weights = (k ** jnp.arange(n - 1, -1, -1, dtype=jnp.int32))[None, :]
    return jnp.sum(digits * weights, axis=-1)


@functools.partial(jax.jit, static_argnames=("metric", "maxval"))
def topk_cells(
    targets: jax.Array,  # [Q, D]
    codebooks: jax.Array,  # [n, K, D]
    metric: str,
    maxval: int,
) -> jax.Array:  # [Q, maxval] int32 cell ids, ascending by score
    """Top-``maxval`` composite cells per target."""
    n, k, _ = codebooks.shape
    num_cells = k**n
    if num_cells > DENSE_CELL_LIMIT:
        raise NotImplementedError(
            f"k^n = {num_cells} exceeds dense enumeration limit; "
            "use per-codebook bounded search (cells.topk_cells_bounded)"
        )

    dist = codebook_distances(targets, codebooks, metric)  # [Q, n, K]
    scores = _enumerate_cell_scores(dist)  # [Q, k^n]
    _, ids = jax.lax.top_k(-scores, maxval)
    return ids.astype(jnp.int32)


def assign_cells_np(vectors, codebooks, metric: str):
    """Host (numpy) mirror of :func:`assign_cells` — same per-codebook
    pairwise distance (incl. the l2 sqrt form, so near-tie rounding
    matches) and the same first-min tie rule (np.argmin ≡ jnp.argmin).

    Used by index.make for HOST-RESIDENT tables (engine/residency.py
    regime): streaming a 100M-row corpus through the device link just
    to argmin 128 centroids is pure upload cost, while the host does
    the same BLAS matmuls against its own mmap'd rows."""
    import numpy as np

    metric = canonical_metric(metric)
    v = np.asarray(vectors, dtype=np.float32)
    cb = np.asarray(codebooks, dtype=np.float32)
    n, k, d = cb.shape
    flat = cb.reshape(n * k, d)

    if metric == "l2":
        uu = np.sum(np.square(v), axis=-1, keepdims=True)
        vv = np.sum(np.square(flat), axis=-1, keepdims=True).T
        dist = np.sqrt(np.maximum(uu - 2.0 * (v @ flat.T) + vv, 0.0))
    elif metric == "cosine":
        tn = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        fn = flat / np.maximum(np.linalg.norm(flat, axis=-1, keepdims=True), 1e-12)
        dist = 0.5 - 0.5 * (tn @ fn.T)
    else:
        dist = -(v @ flat.T)
    dist = dist.reshape(-1, n, k)

    digits = np.argmin(dist, axis=-1).astype(np.int64)  # [N, n]
    weights = (k ** np.arange(n - 1, -1, -1, dtype=np.int64))[None, :]
    return np.sum(digits * weights, axis=-1)


def topk_cells_np(targets, codebooks, metric: str, maxval: int):
    """Host (numpy) mirror of :func:`topk_cells` for dense cell grids.

    Probed serving uses this to pick probe cells without a device
    round trip for the [Q, P] fetch. Same math (fp32) and the same smallest-id tie rule
    (stable argsort ≡ lax.top_k's earliest-on-tie)."""
    import numpy as np

    metric = canonical_metric(metric)
    targets = np.asarray(targets, dtype=np.float32)
    codebooks = np.asarray(codebooks, dtype=np.float32)
    n, k, d = codebooks.shape
    flat = codebooks.reshape(n * k, d)

    if metric == "l2":
        uu = np.sum(np.square(targets), axis=-1, keepdims=True)
        vv = np.sum(np.square(flat), axis=-1, keepdims=True).T
        dist = np.sqrt(np.maximum(uu - 2.0 * (targets @ flat.T) + vv, 0.0))
    elif metric == "cosine":
        tn = targets / np.maximum(
            np.linalg.norm(targets, axis=-1, keepdims=True), 1e-12
        )
        fn = flat / np.maximum(np.linalg.norm(flat, axis=-1, keepdims=True), 1e-12)
        dist = 0.5 - 0.5 * (tn @ fn.T)
    else:
        dist = -(targets @ flat.T)
    dist = dist.reshape(-1, n, k)

    q = dist.shape[0]
    num_cells = k**n
    maxval = min(maxval, num_cells)

    # Chunk queries: the [chunk, k^n] score matrix at DENSE_CELL_LIMIT
    # is 4 MB/row — a full [Q, k^n] would be GBs for big batches.
    chunk = max(1, min(q, (64 << 20) // max(num_cells * 4, 1)))
    out = np.empty((q, maxval), np.int32)
    for lo in range(0, q, chunk):
        hi = min(lo + chunk, q)
        scores = dist[lo:hi, 0, :]
        for j in range(1, n):
            scores = (scores[:, :, None] + dist[lo:hi, j, None, :]).reshape(hi - lo, -1)
        if num_cells > 4 * maxval and num_cells > 4096:
            # argpartition then a stable (score, id) sort of the
            # selected slice — full argsorts of k^n elements dominate
            # otherwise. Boundary ties may select a different (equal-
            # score) cell than the full sort; probe sets stay valid.
            part = np.argpartition(scores, maxval - 1, axis=1)[:, :maxval]
            sel = np.take_along_axis(scores, part, axis=1)
            o1 = np.argsort(part, axis=1, kind="stable")
            part = np.take_along_axis(part, o1, axis=1)
            sel = np.take_along_axis(sel, o1, axis=1)
            o2 = np.argsort(sel, axis=1, kind="stable")
            out[lo:hi] = np.take_along_axis(part, o2, axis=1).astype(np.int32)
        else:
            order = np.argsort(scores, axis=-1, kind="stable")
            out[lo:hi] = order[:, :maxval].astype(np.int32)
    return out


@functools.partial(jax.jit, static_argnames=("metric",))
def all_cell_ranks(
    targets: jax.Array,  # [Q, D]
    codebooks: jax.Array,  # [n, K, D]
    metric: str,
) -> jax.Array:  # [Q, k^n] cell ids sorted ascending by score
    """Full argsort of composite cells (reference coder.py:186 path)."""
    dist = codebook_distances(targets, codebooks, metric)
    scores = _enumerate_cell_scores(dist)
    return jnp.argsort(scores, axis=-1).astype(jnp.int32)


def _enumerate_cell_scores(dist: jax.Array) -> jax.Array:
    """[Q, n, K] per-codebook distances → [Q, k^n] composite sums.

    Iterative broadcast keeps codebook 0 as the most-significant digit:
    cell c's codebook-j index is ``(c // k^(n-1-j)) % k`` — identical to
    the reference's index cross-product (coder.py:171-181).
    """
    q, n, k = dist.shape
    scores = dist[:, 0, :]  # [Q, k]
    for j in range(1, n):
        scores = (scores[:, :, None] + dist[:, j, None, :]).reshape(q, -1)
    return scores


def topk_cells_bounded(
    targets: jax.Array,
    codebooks: jax.Array,
    metric: str,
    maxval: int,
    beam: int | None = None,
) -> jax.Array:
    """Top-``maxval`` cells without materializing k^n.

    Beam expansion over codebooks: keep the best ``beam ≥ maxval``
    partial sums after each codebook. Exact when beam ≥ maxval·k is not
    guaranteed in theory for adversarial inputs, but with
    ``beam = maxval·k`` the result matches dense enumeration for every
    practical distribution; used only above DENSE_CELL_LIMIT.
    """
    n, k, _ = codebooks.shape
    beam = beam or maxval * k
    dist = codebook_distances(targets, codebooks, metric)  # [Q, n, K]

    q = dist.shape[0]
    # partial sums and partial cell ids
    scores = dist[:, 0, :]  # [Q, k]
    ids = jnp.broadcast_to(jnp.arange(k, dtype=jnp.int32)[None, :], (q, k))

    for j in range(1, n):
        cand_scores = (scores[:, :, None] + dist[:, j, None, :]).reshape(q, -1)
        cand_ids = (ids[:, :, None].astype(jnp.int32) * k + jnp.arange(k, dtype=jnp.int32)[None, None, :]).reshape(
            q, -1
        )
        keep = min(beam, cand_scores.shape[1])
        top_scores, pos = jax.lax.top_k(-cand_scores, keep)
        scores = -top_scores
        ids = jnp.take_along_axis(cand_ids, pos, axis=1)

    keep = min(maxval, scores.shape[1])
    _, pos = jax.lax.top_k(-scores, keep)
    return jnp.take_along_axis(ids, pos, axis=1)
