"""fenix_tpu — an accelerator-resident vector database / similarity-search
engine, served on NVIDIA GPUs.

Capability surface of nrlugg/fenix (Arrow-Flight-served tables, k-means
coder + IVF index lifecycle, filtered exact/ANN kNN) re-designed for
JAX: device-resident columnar storage, a fused matmul + bucket-max
phase-1 kernel with two-phase exact top-k, predicate/probe masks pushed below the matmul,
and mesh-sharded multi-chip execution (fenix_tpu.parallel).
"""

from fenix_tpu import coder, expr, index, io, types
from fenix_tpu.flight import Flight, Server
from fenix_tpu.version import __version__

# Extension types MUST register at import: unregistered, a quint8
# column read from disk is a plain fixed_size_list<uint8> and the
# engine would silently search raw codes instead of dequantized values.
types.register_all()

__all__ = [
    "Flight", "Server", "coder", "expr", "index", "io", "types", "__version__",
]
