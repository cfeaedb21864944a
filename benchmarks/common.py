"""Shared helpers for the BASELINE.md config benchmarks.

Each benchmark prints one JSON line. Sizes default to the target
config; ``--scale`` shrinks them to fit a single chip / CPU run
(the driver's official number comes from /root/repo/bench.py).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def sync(x) -> None:
    """Completion fence: JAX returns before the device finishes."""
    import jax

    jax.block_until_ready(x)


def timeit(fn, iters: int = 10) -> float:
    out = fn()
    sync(out[0] if isinstance(out, tuple) else out)
    start = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync(out[0] if isinstance(out, tuple) else out)
    return (time.perf_counter() - start) / iters


def parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=name)
    p.add_argument("--scale", type=float, default=1.0, help="size multiplier (≤1 shrinks)")
    p.add_argument("--iters", type=int, default=10)
    return p


def emit(metric: str, value: float, unit: str, **extra) -> None:
    print(
        json.dumps(
            {"metric": metric, "value": round(value, 2), "unit": unit, "extra": extra}
        )
    )


def device_normal(n: int, d: int, seed: int = 0, chunk: int = 1 << 20):
    """[n, d] f32 standard normals generated on the device in row chunks,
    so the generator's bits buffer stays one chunk wide (a single
    ``jax.random.normal`` call needs twice its output transiently)."""
    import functools

    import jax
    import jax.numpy as jnp

    chunk = min(chunk, n)
    assert n % chunk == 0, (n, chunk)

    @functools.partial(jax.jit, donate_argnums=0)
    def fill(out):
        def body(i, out):
            block = jax.random.normal(
                jax.random.fold_in(jax.random.PRNGKey(seed), i), (chunk, d), jnp.float32
            )
            return jax.lax.dynamic_update_slice(out, block, (i * chunk, 0))

        return jax.lax.fori_loop(0, n // chunk, body, out)

    return fill(jnp.zeros((n, d), jnp.float32))


def make_corpus(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)
