"""Usable device-memory budget resolution, shared by every consumer.

One parser, one fallback: ``FENIX_HBM_BUDGET`` wins; otherwise the
device's reported ``bytes_limit`` scaled by ``FENIX_HBM_FRACTION``;
``None`` = unknown. The env var accepts plain ints AND float notation
(``9e9``) and raises loudly on anything else: the residency router and
the cache evictor must read one spelling the same way.

On the GPU, ``bytes_limit`` is the pool JAX reserved for itself (three
quarters of the card by default). The router plans a corpus as
resident when its need fits 0.9 × fraction × limit, and a corpus that
fits must still leave room for a search's transient buffers. The
default fraction comes from ``benchmarks/hbm_fraction.py`` on an H100
80GB HBM3 at a 400 W power limit (pool 63.76 GB): the largest
fp32-resident 128-d corpus that served a Q=1024 search was 56 Mi rows
(30.06 GB + 16 B/row aux = 0.486 of the pool; 64 Mi rows failed).
0.55 is the smallest two-digit fraction under which the router plans
that corpus as resident (it needs 0.5403), and it still refuses
64 Mi rows. Which source resolved the
budget is surfaced once per process as a stats counter
(``hbm.budget_from_env`` / ``hbm.budget_from_device_scaled``).

The device limit is memoized per process: ``memory_stats()`` is
backend traffic, and the residency router consults the budget on every
search request (the limit is static for the life of the process).
"""

from __future__ import annotations

import os

_ENV = "FENIX_HBM_BUDGET"
_FRACTION_ENV = "FENIX_HBM_FRACTION"
DEFAULT_DEVICE_FRACTION = 0.55
_DEVICE_LIMIT: list = []  # [int | None] once probed
_SOURCES_EMITTED: set = set()  # one stats counter per source per process


def parse_budget(env: str) -> "int | None":
    """Byte count from the env-var string; ``None`` for <= 0 (off)."""
    try:
        b = int(float(env))
    except ValueError:
        raise ValueError(
            f"{_ENV} must be a byte count (e.g. 9000000000 or 9e9), "
            f"got {env!r}"
        ) from None
    return b if b > 0 else None


def _device_fraction() -> float:
    env = os.environ.get(_FRACTION_ENV, "")
    if not env:
        return DEFAULT_DEVICE_FRACTION
    try:
        f = float(env)
    except ValueError:
        raise ValueError(
            f"{_FRACTION_ENV} must be a fraction in (0, 1], got {env!r}"
        ) from None
    if not 0.0 < f <= 1.0:
        raise ValueError(f"{_FRACTION_ENV} must be in (0, 1], got {env!r}")
    return f


def _emit_source(source: str) -> None:
    if source in _SOURCES_EMITTED:
        return
    _SOURCES_EMITTED.add(source)
    from fenix_tpu.utils.metrics import GLOBAL as metrics

    metrics.add(f"hbm.budget_from_{source}")


def budget_bytes() -> "int | None":
    """Usable HBM in bytes: env override, else the device-reported
    limit scaled by the conservative usable fraction, else ``None``
    (callers keep their no-budget behavior)."""
    env = os.environ.get(_ENV, "")
    if env:
        b = parse_budget(env)
        if b is not None:
            _emit_source("env")
            return b
    if not _DEVICE_LIMIT:
        try:
            import jax

            stats = jax.local_devices()[0].memory_stats() or {}
            _DEVICE_LIMIT.append(int(stats.get("bytes_limit") or 0) or None)
        except Exception:
            _DEVICE_LIMIT.append(None)
    limit = _DEVICE_LIMIT[0]
    if limit is None:
        return None
    _emit_source("device_scaled")
    return int(limit * _device_fraction())
