"""Random-batch iteration + host→device prefetch pipeline.

Capability parity: /root/reference/src/fenix/io/batch/batch.py
(RandomBatchIterator: full random permutation, drop remainder;
``imap`` wraps it in a torch DataLoader worker pool — dead code in the
reference, SURVEY.md §2.2.5). Here the iterator yields dense numpy
blocks (via the native threaded gather) and ``prefetch_to_device``
double-buffers host→device transfers so the device never waits on
ingest — the DataLoader-worker-pool role (SURVEY.md §2.3 last row).
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Callable, Iterator, Sequence

import jax
import numpy as np

from fenix_tpu import native
from fenix_tpu.io import ingest, table


class RandomBatchIterator:
    """Permuted fixed-size batches over a table column (or columns).

    One pass = one epoch: a fresh full permutation, remainder dropped
    (reference batch.py:21-31 semantics, minus the O(N) boolean-mask
    filter per batch — rows come out via a threaded gather instead).
    """

    def __init__(
        self,
        root: str,
        name: str | Sequence[str],
        size: int,
        column: str,
        seed: int | None = None,
    ) -> None:
        self.root = root
        self.name = name
        self.size = size
        self.column = column
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        data = table.load(self.root, self.name)
        matrix = ingest.fixed_size_list_to_numpy(data.column(self.column))
        num_rows = matrix.shape[0]
        perm = self.rng.permutation(num_rows)
        perm = perm[: num_rows // self.size * self.size]
        for start in range(0, perm.size, self.size):
            yield native.gather_rows(matrix, perm[start : start + self.size])


def prefetch_to_device(
    iterator: Iterator[np.ndarray],
    buffer_size: int = 2,
    transform: Callable[[np.ndarray], jax.Array] | None = None,
) -> Iterator[jax.Array]:
    """Double-buffered host→device pipeline: batch ``i+1`` transfers
    (and its host-side assembly runs in a worker thread) while batch
    ``i`` computes."""
    put = transform if transform is not None else (lambda x: jax.device_put(x))

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        queue: collections.deque = collections.deque()
        it = iter(iterator)

        def produce():
            try:
                return put(next(it))
            except StopIteration:
                return None

        for _ in range(buffer_size):
            queue.append(pool.submit(produce))

        while queue:
            item = queue.popleft().result()
            if item is None:
                break
            queue.append(pool.submit(produce))
            yield item
