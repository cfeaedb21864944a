"""Multi-host bootstrap: jax.distributed + sharded corpus manifests.

SURVEY.md §2.4: the reference is strictly single-process; scaling here
follows the north star — one engine process per accelerator host,
``jax.distributed.initialize`` for the cross-host rendezvous, corpus
rows hash-partitioned across hosts (fenix_tpu.native.hash_partition on
ingest), each host feeding its local shard into the global mesh, with
the candidate-only top-k merge (parallel.search) riding the
interconnect.

Single-host multi-chip needs none of this — ``mesh.make_mesh()`` over
local devices is enough. This module is the pod-slice entry point.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Typed cluster/topology config (SURVEY.md §5 config-system plan:
    dataclass tree serialized as JSON, no pickled blobs)."""

    coordinator_address: str | None = None  # "host:port"; None = single host
    num_processes: int = 1
    process_id: int = 0
    model_parallel: int = 1

    @staticmethod
    def from_env() -> "ClusterConfig":
        return ClusterConfig(
            coordinator_address=os.environ.get("FENIX_COORDINATOR"),
            num_processes=int(os.environ.get("FENIX_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("FENIX_PROCESS_ID", "0")),
            model_parallel=int(os.environ.get("FENIX_MODEL_PARALLEL", "1")),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def initialize(config: ClusterConfig | None = None):
    """Bring up the global device view and build the engine mesh.

    Returns the mesh spanning every chip of every host. Idempotent for
    the single-host case.
    """
    import jax

    from fenix_tpu.parallel import mesh as mesh_mod

    config = config or ClusterConfig.from_env()

    if config.coordinator_address and config.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=config.coordinator_address,
            num_processes=config.num_processes,
            process_id=config.process_id,
        )

    return mesh_mod.make_mesh(model_parallel=config.model_parallel)


@dataclasses.dataclass(frozen=True)
class ShardManifest:
    """Which table shards live on which host (immutable-artifact model:
    shard files are plain catalog tables named ``<table>@<shard>``)."""

    table: str
    num_shards: int

    def shard_name(self, shard: int) -> str:
        return f"{self.table}@{shard}"

    def local_shards(self, process_id: int, num_processes: int) -> list[int]:
        return [s for s in range(self.num_shards) if s % num_processes == process_id]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(text: str) -> "ShardManifest":
        return ShardManifest(**json.loads(text))


def manifest_path(root: str, table_name: str) -> str:
    from fenix_tpu.io import table as table_mod

    return os.path.join(root, table_mod.LOCATION, table_name + ".manifest.json")


def load_manifest(root: str, table_name: str) -> "ShardManifest | None":
    path = manifest_path(root, table_name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return ShardManifest.from_json(f.read())


def resolve_source(root: str, source):
    """Expand repartitioned table names into their shard lists.

    The serving side of the shuffle: a search/read addressed at a
    repartitioned table ``t`` resolves to ``[t@0, …, t@S-1]`` — the
    engine's multi-source machinery (concatenated loads, per-source
    index files, row-sharded device columns) then serves it unchanged.
    Non-repartitioned names pass through untouched."""
    if isinstance(source, str):
        manifest = load_manifest(root, source)
        if manifest is None:
            return source
        return [manifest.shard_name(s) for s in range(manifest.num_shards)]
    out: list[str] = []
    for name in source:
        resolved = resolve_source(root, name)
        out.extend([resolved] if isinstance(resolved, str) else resolved)
    return out


def drop_repartition(root: str, table_name: str) -> bool:
    """Remove a table's manifest and shard tables (overwrite/drop of a
    repartitioned name). Returns whether one existed."""
    from fenix_tpu import index as index_mod
    from fenix_tpu.io import table as table_mod

    manifest = load_manifest(root, table_name)
    if manifest is None:
        return False
    for s in range(manifest.num_shards):
        name = manifest.shard_name(s)
        index_mod.drop_for_source(root, name)
        table_mod.drop(root, name)
    os.unlink(manifest_path(root, table_name))
    return True


def _device_shuffle_ids(mesh, keys, num_shards: int) -> "list":
    """Row-id routing on DEVICE: exchange (key, row-id) pairs through
    the all_to_all shuffle kernel (parallel.shuffle); each shard's
    received ids drive the host-side table gather. Row payloads never
    cross the device — arbitrary Arrow schemas (strings, nested types)
    repartition through the same kernel that moves dense rows."""
    import jax
    import numpy as np

    from fenix_tpu.parallel import shuffle as pshuffle
    from fenix_tpu.parallel.mesh import row_sharding

    n = keys.size
    n_pad = -(-n // num_shards) * num_shards
    ids = np.full(n_pad, -1, np.int32)
    ids[:n] = np.arange(n, dtype=np.int32)
    keys_pad = np.zeros(n_pad, np.int32)
    keys_pad[:n] = keys.astype(np.int32)  # both hash paths use low 32 bits

    rows_dev = jax.device_put(ids, row_sharding(mesh, 1))
    keys_dev = jax.device_put(keys_pad, row_sharding(mesh, 1))

    capacity = pshuffle.estimate_capacity(keys, num_shards, n_pad // num_shards, safety=2.0)
    for cap in (capacity, n_pad // num_shards):  # retry at the provable bound
        # large payloads double-buffer the exchange (4 chunks); tiny
        # ones keep the single all_to_all (per-collective latency wins)
        chunks = 4 if cap >= 4096 else 1
        cap = -(-cap // chunks) * chunks
        fn = pshuffle.build_shuffle(mesh, cap, (), chunks=chunks)
        recv_ids, _, valid, overflow = fn(rows_dev, keys_dev)
        if not bool(np.asarray(overflow).any()):
            break

    ids_all = np.asarray(recv_ids)
    valid_all = np.asarray(valid)
    per = ids_all.size // num_shards
    out = []
    for s in range(num_shards):
        sl = slice(s * per, (s + 1) * per)
        sel = ids_all[sl][valid_all[sl]]
        out.append(np.sort(sel[sel >= 0]))
    return out


def repartition(
    root: str,
    table_name: str,
    num_shards: int,
    key_column: str = "id",
    mesh=None,
) -> ShardManifest:
    """Hash-partition a catalog table into ``<t>@<shard>`` tables, write
    the manifest, and retire the original name — searches and reads
    resolve it to the shard list from then on (:func:`resolve_source`).

    Device path (mesh active and ``num_shards`` == mesh size): the
    (key, row-id) exchange runs through the all_to_all shuffle kernel.
    Host path otherwise: ``native.hash_partition``. Both use the same
    hash, so the placement is identical.
    """
    import numpy as np
    import pyarrow as pa

    from fenix_tpu import index as index_mod
    from fenix_tpu import native
    from fenix_tpu.io import table as table_mod
    from fenix_tpu.io.locks import catalog_lock

    with catalog_lock(root):
        data = table_mod.load(root, table_name)
        keys = np.asarray(data.column(key_column)).astype(np.int64)

        if mesh is not None and int(mesh.devices.size) == num_shards and keys.size:
            shard_ids = _device_shuffle_ids(mesh, keys, num_shards)
        else:
            parts, _ = native.hash_partition(keys, num_shards)
            shard_ids = [np.flatnonzero(parts == s) for s in range(num_shards)]

        manifest = ShardManifest(table=table_name, num_shards=num_shards)
        for shard, ids in enumerate(shard_ids):
            piece = data.take(pa.array(np.asarray(ids, dtype=np.int64)))
            table_mod.make(root, manifest.shard_name(shard), piece.to_reader())

        path = manifest_path(root, table_name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(manifest.to_json())
        os.replace(tmp, path)

        # retire the original: its indexes are row-misaligned under the
        # new layout, and the name now resolves to the shard list
        index_mod.drop_for_source(root, table_name)
        table_mod.drop(root, table_name)
    return manifest


def shard_table(root: str, table_name: str, num_shards: int, key_column: str = "id") -> ShardManifest:
    """Split a catalog table into hash-partitioned shard tables
    (host-path :func:`repartition` — rows routed by the engine hash,
    written as ``<table>@<shard>`` catalog entries; each host then
    loads only its shards)."""
    return repartition(root, table_name, num_shards, key_column=key_column)
