"""Distributed shuffle: hash-partitioned row exchange over the mesh.

North-star component (BASELINE.json config 4: "hash-partitioned tables,
skew-handled shuffle"). Each device hash-partitions its local rows by
key, packs them into fixed-capacity per-destination buffers (static
shapes — XLA collectives need static buffers), and exchanges them with
a single ``all_to_all``. Raw row payloads move exactly once.

Skew handling is sampled (SURVEY.md §5): ``estimate_capacity`` bounds
the per-destination buffer from a key sample instead of the worst case,
trading a provable bound for ~balanced memory; overflow is detected and
reported per shard so the caller can re-shuffle with a larger capacity
(deterministic failure, never silent row loss).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fenix_tpu.ops import relational
from fenix_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS


def estimate_capacity(
    sample_keys: np.ndarray, num_partitions: int, rows_per_shard: int, safety: float = 1.5
) -> int:
    """Per-destination buffer capacity from a host-side key sample.

    capacity = rows_per_shard · max-partition-fraction · safety, floored
    at the balanced share. Sampling error shrinks as 1/√sample; the
    overflow flag catches the residual tail.
    """
    parts, counts = _host_hash(sample_keys, num_partitions)
    frac = counts.max() / max(len(sample_keys), 1)
    balanced = rows_per_shard / num_partitions
    cap = int(np.ceil(max(frac * rows_per_shard * safety, balanced * safety)))
    return min(cap, rows_per_shard)


def _host_hash(keys: np.ndarray, num_partitions: int) -> tuple[np.ndarray, np.ndarray]:
    from fenix_tpu import native

    return native.hash_partition(keys, num_partitions)


def build_shuffle(
    mesh: jax.sharding.Mesh,
    capacity: int,
    row_shape: tuple[int, ...],
    chunks: int = 1,
):
    """Compile the exchange step.

    Returns ``fn(rows [N, *row_shape] row-sharded, keys [N] row-sharded)
    -> (recv [S·cap, *row_shape] row-sharded, recv_keys, valid mask,
    overflow [S] bool)`` — after the call each device holds exactly the
    rows whose key hashes to it, ``valid`` marking real rows.

    ``chunks > 1`` double-buffers the exchange (VERDICT r2 #3): the
    capacity window splits into chunks, and each scan step issues the
    all_to_all for the chunk packed on the PREVIOUS step while
    gathering the next chunk's send buffer — the pack compute has no
    data dependence on the in-flight exchange, so async collectives
    hide the wire time behind it. ``chunks=1`` keeps the single
    blocking exchange (right for small payloads, where chunking only
    adds per-collective latency).
    """
    from jax.sharding import PartitionSpec as P

    axes = (DATA_AXIS, MODEL_AXIS)
    n_shards = mesh.devices.size
    assert capacity % chunks == 0 or chunks == 1, (capacity, chunks)
    chunk = capacity // chunks

    def _all_to_all2(x):
        # split leading [S, ...] over both mesh axes
        x = jax.lax.all_to_all(x, axes, split_axis=0, concat_axis=0, tiled=False)
        # tiled=False: [S, 1, ...] → squeeze the split remnant
        return x.reshape(x.shape[0], *x.shape[2:]) if x.ndim > 2 and x.shape[1] == 1 else x

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axes), P(axes)),
        out_specs=(P(axes), P(axes), P(axes), P(axes)),
        check_vma=False,
    )
    def exchange(rows_local, keys_local):
        b = keys_local.shape[0]
        parts = relational.hash_partition(keys_local, n_shards)  # [B]

        # stable sort rows by destination
        iota = jnp.arange(b, dtype=jnp.int32)
        sorted_parts, perm = jax.lax.sort(
            (parts, iota), dimension=0, is_stable=True, num_keys=1
        )
        rows_sorted = jnp.take(rows_local, perm, axis=0)
        keys_sorted = jnp.take(keys_local, perm, axis=0)

        starts = jnp.searchsorted(
            sorted_parts, jnp.arange(n_shards, dtype=parts.dtype), side="left"
        )
        ends = jnp.searchsorted(
            sorted_parts, jnp.arange(n_shards, dtype=parts.dtype), side="right"
        )
        sizes = ends - starts
        overflow = sizes > capacity

        def pack(c):
            # gather chunk ``c`` of every destination window: [S, chunk]
            slot = c * chunk + jnp.arange(chunk, dtype=jnp.int32)
            idx = starts[:, None] + slot[None, :]
            valid = slot[None, :] < jnp.minimum(sizes, capacity)[:, None]
            idx = jnp.clip(idx, 0, b - 1)
            send_rows = jnp.take(rows_sorted, idx.reshape(-1), axis=0).reshape(
                n_shards, chunk, *rows_local.shape[1:]
            )
            send_keys = jnp.take(keys_sorted, idx.reshape(-1), axis=0).reshape(
                n_shards, chunk
            )
            return send_rows, send_keys, valid

        if chunks == 1:
            send_rows, send_keys, valid = pack(0)
            recv_rows = _all_to_all2(send_rows)
            recv_keys = _all_to_all2(send_keys)
            recv_valid = _all_to_all2(valid)
        else:
            def body(carry, c):
                # exchange the chunk packed LAST step; pack the next one
                # while it is in flight (independent gather compute)
                send_rows, send_keys, valid = carry
                recv = (
                    _all_to_all2(send_rows),
                    _all_to_all2(send_keys),
                    _all_to_all2(valid),
                )
                nxt = pack(jnp.minimum(c + 1, chunks - 1))
                return nxt, recv

            _, (rr, rk, rv) = jax.lax.scan(
                body, pack(0), jnp.arange(chunks, dtype=jnp.int32)
            )
            # [chunks, S, chunk, ...] → [S, chunks, chunk, ...] → [S, cap, ...]
            recv_rows = jnp.swapaxes(rr, 0, 1).reshape(
                n_shards, capacity, *rows_local.shape[1:]
            )
            recv_keys = jnp.swapaxes(rk, 0, 1).reshape(n_shards, capacity)
            recv_valid = jnp.swapaxes(rv, 0, 1).reshape(n_shards, capacity)

        return (
            recv_rows.reshape(n_shards * capacity, *rows_local.shape[1:]),
            recv_keys.reshape(n_shards * capacity),
            recv_valid.reshape(n_shards * capacity),
            overflow,
        )

    return jax.jit(exchange)
