"""Arrow ⇄ device-array bridge.

Role parity: /root/reference/src/fenix/io/torch/torch.py:6-10 (zero-copy
FixedSizeList → Tensor via DLPack). Here the bridge targets ``jax.Array``:
Arrow FixedSizeList columns are viewed as dense ``[rows, list_size]``
numpy arrays without copying on the host, then transferred to device
(padded to kernel-friendly block multiples, with a validity row count kept
alongside so kernels can mask the tail).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def vector_type(field_type: pa.DataType) -> pa.FixedSizeListType:
    """The LOGICAL FixedSizeList type of a vector column, unwrapping
    extension types (fenix_tpu.types — typed columns are first-class
    search inputs). quint8 columns report float32 values: the engine
    searches their DEQUANTIZED form, so dimensions and the returned
    ``__DISTANCE__`` dtype are float, not the uint8 storage codes."""
    if isinstance(field_type, pa.ExtensionType):
        from fenix_tpu.types import quint8 as quint8_mod

        storage = field_type.storage_type
        if isinstance(field_type, quint8_mod.QUInt8TensorType):
            return pa.list_(pa.float32(), storage.list_size)
        field_type = storage
    assert pa.types.is_fixed_size_list(field_type), field_type
    return field_type


def fixed_size_list_to_numpy(array: pa.Array | pa.ChunkedArray) -> np.ndarray:
    """Zero-copy view of a FixedSizeList array as ``[rows, list_size]``.

    Extension-typed columns (TensorType & co.) are viewed through their
    FixedSizeList storage. Requires a null-free array (the catalog never
    produces nulls for vector columns; mirrors the reference's DLPack
    assumption).
    """
    if isinstance(array, pa.ChunkedArray):
        if array.num_chunks == 0:
            # empty table (e.g. delete_rows removed every row): combine
            # is safe at zero size and yields one empty array of the
            # right type, so the extension/dequant handling below still
            # applies — the result is a clean [0, list_size] matrix
            array = array.combine_chunks()
        elif array.num_chunks == 1:
            array = array.chunk(0)
        else:
            # combine_chunks would build ONE array, capped at 2^31 flat
            # elements (a 10M×768 column is 7.7B) — copy per chunk into
            # a preallocated matrix instead (peak = 1× the output)
            views = [fixed_size_list_to_numpy(c) for c in array.chunks]
            out = np.empty(
                (sum(v.shape[0] for v in views), views[0].shape[1]),
                views[0].dtype,
            )
            off = 0
            for v in views:
                out[off : off + v.shape[0]] = v
                off += v.shape[0]
            return out
    dequant = None
    if isinstance(array, pa.ExtensionArray):
        from fenix_tpu.types import quint8 as quint8_mod

        if isinstance(array.type, quint8_mod.QUInt8TensorType):
            # quantized-at-rest column: the engine's logical view is the
            # dequantized fp32 matrix (affine params ride in the type)
            dequant = (np.float32(array.type.scale), np.float32(array.type.shift))
        array = array.storage

    assert pa.types.is_fixed_size_list(array.type), array.type
    size = array.type.list_size

    values = array.values
    # Respect any slicing offset on the parent array.
    start = array.offset * size
    values = values.slice(start, len(array) * size)

    flat = values.to_numpy(zero_copy_only=True)
    out = flat.reshape(-1, size)
    if dequant is not None:
        scale, shift = dequant
        out = (out.astype(np.float32) - shift) * scale
    return out


def scalar_column_to_numpy(array: pa.Array | pa.ChunkedArray) -> np.ndarray:
    """Dense numpy view of a primitive column (zero-copy when possible)."""
    if isinstance(array, pa.ChunkedArray):
        array = array.combine_chunks()
    return array.to_numpy(zero_copy_only=array.null_count == 0)


class DeviceColumn(NamedTuple):
    """A device-resident dense column padded to a block multiple."""

    data: jax.Array  # [rows_padded, dim] or [rows_padded]
    rows: int  # valid rows (<= rows_padded)

    @property
    def rows_padded(self) -> int:
        return self.data.shape[0]


def to_device_matrix(
    array: pa.Array | pa.ChunkedArray | np.ndarray,
    *,
    block: int = 1024,
    dtype: jnp.dtype | None = None,
    sharding: jax.sharding.Sharding | None = None,
) -> DeviceColumn:
    """Pad a ``[N, D]`` host matrix to ``N_pad`` rows and move to device."""
    if not isinstance(array, np.ndarray):
        array = fixed_size_list_to_numpy(array)

    rows = array.shape[0]
    rows_padded = max(round_up(rows, block), block)
    if rows_padded != rows:
        from fenix_tpu import native

        array = native.pack_rows(array, rows_padded)

    data = jnp.asarray(array, dtype=dtype)
    if sharding is not None:
        data = jax.device_put(data, sharding)
    return DeviceColumn(data=data, rows=rows)


def to_device_vector(
    array: pa.Array | pa.ChunkedArray | np.ndarray,
    *,
    block: int = 1024,
    dtype: jnp.dtype | None = None,
    fill: float | int = 0,
    sharding: jax.sharding.Sharding | None = None,
) -> DeviceColumn:
    """Pad a 1-D host column and move to device (for ids / filter keys)."""
    if not isinstance(array, np.ndarray):
        array = scalar_column_to_numpy(array)

    rows = array.shape[0]
    rows_padded = max(round_up(rows, block), block)
    if rows_padded != rows:
        if fill in (0, -1) and np.issubdtype(array.dtype, np.integer):
            from fenix_tpu import native

            array = native.pack_rows(array, rows_padded, 0xFF if fill == -1 else 0)
        elif fill == 0:
            from fenix_tpu import native

            array = native.pack_rows(array, rows_padded)
        else:
            pad = np.full((rows_padded - rows,), fill, dtype=array.dtype)
            array = np.concatenate([array, pad], axis=0)

    data = jnp.asarray(array, dtype=dtype)
    if sharding is not None:
        data = jax.device_put(data, sharding)
    return DeviceColumn(data=data, rows=rows)


def from_device(array: jax.Array, rows: int | None = None) -> np.ndarray:
    """Device → host, trimming any padding rows."""
    host = np.asarray(array)
    return host if rows is None else host[:rows]


def numpy_to_fixed_size_list(matrix: np.ndarray, value_type: pa.DataType) -> pa.Array:
    """Dense ``[N, D]`` host matrix → Arrow FixedSizeList array."""
    n, d = matrix.shape
    flat = pa.array(matrix.reshape(-1), type=value_type)
    return pa.FixedSizeListArray.from_arrays(flat, list_size=d)
