"""uint8 affine-quantized tensor columns.

Capability parity: /root/reference/src/fenix/ex/arrow/quint8/quint8.py
(per-tensor scale/zero-point affine quantization over uint8 FixedSizeList
storage). torch's quantized-tensor machinery is replaced with explicit
numpy/jax affine math; dynamic quantization mirrors torch's
``quantize_per_tensor_dynamic(reduce_range=True)`` (quint8 range 0-127).

The quantized path cuts device-memory traffic for bandwidth-bound
scans: int8 corpus blocks feed the matmul directly with the scale
folded into the query (see ops.distance bf16/int8 roadmap).
"""

from __future__ import annotations

import json
from typing import Sequence, Type

import numpy as np
import pyarrow as pa


def dynamic_quantize(x: np.ndarray, reduce_range: bool = True) -> tuple[np.ndarray, float, int]:
    """Affine-quantize to uint8: returns (q, scale, zero_point) with
    ``x ≈ scale · (q − zero_point)`` — torch quantize_per_tensor_dynamic
    semantics (reference quint8.py:23-35)."""
    x = np.asarray(x, dtype=np.float32)
    qmax = 127 if reduce_range else 255
    lo = min(float(x.min()), 0.0)
    hi = max(float(x.max()), 0.0)
    scale = (hi - lo) / qmax if hi > lo else 1.0
    zero_point = int(round(-lo / scale)) if scale else 0
    zero_point = max(0, min(qmax, zero_point))
    q = np.clip(np.round(x / scale) + zero_point, 0, qmax).astype(np.uint8)
    return q, scale, zero_point


class QUInt8NDArray(np.ndarray):
    """uint8 ndarray carrying (scale, shift) affine params
    (reference quint8.py:11-53)."""

    scale: float
    shift: int

    def __new__(cls, array: np.ndarray, scale: float, shift: int) -> "QUInt8NDArray":
        q = np.asarray(array, dtype=np.uint8).view(cls)
        q.scale = scale
        q.shift = shift
        return q

    def __array_finalize__(self, obj) -> None:
        # numpy creates slices/views without rerunning __new__; carry
        # the affine params along so sliced arrays still dequantize
        if obj is not None:
            self.scale = getattr(obj, "scale", 1.0)
            self.shift = getattr(obj, "shift", 0)

    @staticmethod
    def quantize(array: np.ndarray) -> "QUInt8NDArray":
        q, scale, shift = dynamic_quantize(array)
        return QUInt8NDArray(q, scale, shift)

    def dequantize(self) -> np.ndarray:
        return self.scale * (self.astype(np.float32).view(np.ndarray) - self.shift)


class QUInt8TensorType(pa.ExtensionType):
    def __init__(
        self, shape: Sequence[int], scale: float, shift: int, qmax: int = 127
    ) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.scale = float(scale)
        self.shift = int(shift)
        # the code range the column was quantized into; recorded so
        # appends clip to the SAME range (torch reduce_range parity)
        self.qmax = int(qmax)
        size = int(np.prod(self.shape))
        super().__init__(pa.list_(pa.uint8(), size), "fenix_tpu.quint8")

    def __arrow_ext_serialize__(self) -> bytes:
        return json.dumps(
            {
                "shape": self.shape,
                "scale": self.scale,
                "shift": self.shift,
                "qmax": self.qmax,
            }
        ).encode()

    @classmethod
    def __arrow_ext_deserialize__(
        cls, storage_type: pa.DataType, serialized: bytes
    ) -> "QUInt8TensorType":
        return QUInt8TensorType(**json.loads(serialized.decode()))

    def __arrow_ext_class__(self) -> Type["QUInt8TensorArray"]:
        return QUInt8TensorArray

    def __arrow_ext_scalar_class__(self) -> Type["QUInt8TensorScalar"]:
        return QUInt8TensorScalar


class QUInt8TensorArray(pa.ExtensionArray):
    @staticmethod
    def from_numpy(
        tensor: np.ndarray, like: "QUInt8TensorType | None" = None
    ) -> "QUInt8TensorArray":
        """Quantize ``tensor`` to a quint8 column. Pass ``like=`` an
        existing column's type to reuse ITS affine params — required
        when appending/upserting into a quint8 table (dynamic
        quantization would mint new params and the schemas would never
        match)."""
        if like is not None:
            # Clip to the range the column was quantized into (qmax=127
            # for reduce_range parity) — appended rows must not occupy
            # codes the original column never emits. Reuse ``like``
            # itself so the chunk's type compares equal on append even
            # across metadata-version differences.
            x = np.asarray(tensor, dtype=np.float32)
            qmax = getattr(like, "qmax", 127)
            q = np.clip(np.round(x / like.scale) + like.shift, 0, qmax).astype(
                np.uint8
            )
            num_rows = q.shape[0]
            flat = np.ascontiguousarray(q).reshape(num_rows, -1)
            storage = pa.FixedSizeListArray.from_arrays(
                pa.array(flat.reshape(-1)), list_size=flat.shape[-1]
            )
            return pa.ExtensionArray.from_storage(like, storage)
        if isinstance(tensor, QUInt8NDArray):
            q, scale, shift = tensor.view(np.ndarray), tensor.scale, tensor.shift
        else:
            q, scale, shift = dynamic_quantize(tensor)
        num_rows, *shape = q.shape
        flat = np.ascontiguousarray(q).reshape(num_rows, -1)
        storage = pa.FixedSizeListArray.from_arrays(
            pa.array(flat.reshape(-1)), list_size=flat.shape[-1]
        )
        return pa.ExtensionArray.from_storage(
            QUInt8TensorType(shape, scale, shift), storage
        )

    def to_numpy(self) -> QUInt8NDArray:
        flat = self.storage.flatten().to_numpy(zero_copy_only=False)
        return QUInt8NDArray(
            flat.reshape(-1, *self.type.shape), self.type.scale, self.type.shift
        )

    def dequantize(self) -> np.ndarray:
        return self.to_numpy().dequantize()

    def to_jax_quantized(self):
        """(uint8 jax array, scale, shift) — feed int8 matmul paths."""
        import jax.numpy as jnp

        return (
            jnp.asarray(self.to_numpy().view(np.ndarray)),
            self.type.scale,
            self.type.shift,
        )


class QUInt8TensorScalar(pa.ExtensionScalar):
    def to_numpy(self) -> QUInt8NDArray:
        return QUInt8NDArray(
            np.asarray(self.value.values).reshape(*self.type.shape),
            self.type.scale,
            self.type.shift,
        )

    def dequantize(self) -> np.ndarray:
        return self.to_numpy().dequantize()


def from_numpy(tensor: np.ndarray) -> QUInt8TensorArray:
    return QUInt8TensorArray.from_numpy(tensor)


def register() -> None:
    try:
        pa.register_extension_type(QUInt8TensorType((1,), 1.0, 0))
    except pa.ArrowKeyError:
        pass
