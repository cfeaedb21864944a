"""Distance metrics on device (metric canon, pairwise matrices).

Semantics parity: /root/reference/src/fenix/io/coder/coder.py:38-50
(distance: l2 via cdist, cosine as ``0.5 - 0.5·cos``, dot as negated
inner product — all "smaller is closer").

Top-k search lives in fenix_tpu.ops.topk2 (two-phase bucket-max kernels
— the measured-fastest strategy; the round-1 streaming-scan search that
used to live here was superseded and removed). This module keeps the
value-exact primitives: canonical metric names, normalization, the
fp32-true pairwise matrix, and the full-matrix ``all_distances`` used
by the unselective no-top-k read.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Canonical metric names; aliases mirror flight.py:254 of the reference.
METRIC_ALIASES: dict[str, str] = {
    "l2": "l2",
    "euclidean": "l2",
    "cosine": "cosine",
    "dot": "dot",
    "inner_product": "dot",
}

NEG_INF = float("-inf")


def canonical_metric(metric: str) -> str:
    try:
        return METRIC_ALIASES[metric]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; expected one of {sorted(METRIC_ALIASES)}")


def normalize(x: jax.Array, axis: int = -1, eps: float = 1e-12) -> jax.Array:
    """L2-normalize along ``axis`` (torch.nn.functional.normalize semantics:
    divide by max(norm, eps), reference coder.py:43-44)."""
    norm = jnp.sqrt(jnp.sum(jnp.square(x), axis=axis, keepdims=True))
    return x / jnp.maximum(norm, eps)


def pairwise_distance(
    u: jax.Array, v: jax.Array, metric: str, precision=None
) -> jax.Array:
    """``[Q, D] × [N, D] → [Q, N]`` distance matrix (fp32 accumulation).

    l2 uses the matmul expansion ``|u|² − 2u·v + |v|²`` (clamped at 0)
    — the same formulation torch.cdist selects for D > 25, so values
    match the reference bit-for-bit up to fp32 reduction order.

    ``precision``: pass ``jax.lax.Precision.HIGHEST`` on user-facing
    value paths (on the GPU the default runs fp32 matmuls in TF32);
    leave None for selection-tolerant callers (k-means steps).
    """
    metric = canonical_metric(metric)

    if metric == "l2":
        uu = jnp.sum(jnp.square(u), axis=-1, keepdims=True)  # [Q, 1]
        vv = jnp.sum(jnp.square(v), axis=-1, keepdims=True).T  # [1, N]
        uv = jax.lax.dot_general(
            u,
            v,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=precision,
        )
        return jnp.sqrt(jnp.maximum(uu - 2.0 * uv + vv, 0.0))

    if metric == "cosine":
        u = normalize(u)
        v = normalize(v)
        uv = jax.lax.dot_general(
            u,
            v,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=precision,
        )
        return 0.5 - 0.5 * uv

    # dot / inner_product
    uv = jax.lax.dot_general(
        u,
        v,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    return -uv


@functools.partial(jax.jit, static_argnames=("metric",))
def all_distances(corpus: jax.Array, queries: jax.Array, metric: str) -> jax.Array:
    """Full ``[Q, N_pad]`` distance matrix — for the no-top-k read path
    (reference index.py:162 appends a distance column to every row).
    Values are user-facing → fp32-true matmul."""
    return pairwise_distance(queries, corpus, metric, precision=jax.lax.Precision.HIGHEST)
