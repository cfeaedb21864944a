"""The largest fp32-resident corpus that still serves a Q=1024 search,
against JAX's device memory pool — the measurement behind
``fenix_tpu.utils.hbm.DEFAULT_DEVICE_FRACTION``.

Grows an N × D fp32 corpus (generated on the device) in steps until a
batch-1024 exact search (``topk2.topk_two_phase``, k=16) fails for
want of memory, and prints one JSON line with the pool size
(``bytes_limit``), the largest N that served, and the fraction the
residency router must plan into for that corpus to count as fitting:
``(4·N·D + 16·N) / (0.9 · bytes_limit)`` — the router's dual-residency
need over its 0.9 safety factor (engine/residency.py).

    python -m benchmarks.hbm_fraction [--dim 128] [--start 8] [--step 8]
"""

from __future__ import annotations

import argparse
import json


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--start", type=int, default=8, help="first N, in Mi rows")
    p.add_argument("--step", type=int, default=8, help="N step, in Mi rows")
    p.add_argument("--unit", type=int, default=1 << 20, help="rows per Mi")
    args = p.parse_args()

    import jax

    from benchmarks.common import device_normal
    from fenix_tpu.ops import topk2

    dev = jax.devices()[0]
    limit = int(dev.memory_stats()["bytes_limit"])
    d, q = args.dim, 1024
    queries = jax.random.normal(jax.random.PRNGKey(1), (q, d))
    served, failed, tried = 0, None, []
    n = args.start * args.unit
    while n * d * 4 < limit:
        try:
            corpus = device_normal(n, d, chunk=min(n, args.unit))
            am, aa = topk2.prepare_aux(corpus, None, "cosine")
            jax.block_until_ready(
                topk2.topk_two_phase(corpus, queries, am, aa, k=16, metric="cosine")
            )
            served = n
            tried.append([n, "ok"])
        except Exception as e:  # noqa: BLE001 — out of memory ends the sweep
            failed = f"{type(e).__name__}: {str(e)[:200]}"
            tried.append([n, "failed"])
            break
        finally:
            corpus = am = aa = None
        n += args.step * args.unit
    need = 4 * served * d + 16 * served
    print(json.dumps({
        "device": dev.device_kind, "bytes_limit": limit, "dim": d, "q": q,
        "largest_rows_served": served, "corpus_bytes": 4 * served * d,
        "dual_need_bytes": need, "fraction_of_limit": need / limit,
        "router_fraction": need / (0.9 * limit), "first_failure": failed,
        "tried": tried,
    }))


if __name__ == "__main__":
    main()
