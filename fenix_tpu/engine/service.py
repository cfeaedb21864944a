"""Wire-config → engine dispatch, shared by the Flight server and the
replay tool so recorded queries re-execute on exactly the code path
that produced them (including join/aggregate and precision)."""

from __future__ import annotations

from typing import Any

import pyarrow as pa

from fenix_tpu import expr as expr_mod
from fenix_tpu.engine import analytics, batching, executor
from fenix_tpu.engine.session import DeviceCache


def request_from_config(config: dict[str, Any], target: Any) -> executor.SearchRequest:
    return executor.SearchRequest(
        source=config["source"],
        column=config["column"],
        target=target,
        metric=config.get("metric"),
        coding=config.get("coding"),
        select=config.get("select"),
        filter=(
            expr_mod.Expr.from_dict(config["filter"])
            if config.get("filter") is not None
            else None
        ),
        maxval=config.get("maxval"),
        probes=config.get("probes"),
        precision=config.get("precision") or "fp32",
        residency=config.get("residency") or "auto",
        extra=config.get("extra") or {},
    )


def run_search_config(cache: DeviceCache, config: dict[str, Any], target: Any) -> pa.Table:
    from fenix_tpu.parallel import distributed

    # repartitioned names resolve to their shard lists (the serving
    # side of the shuffle); multi-source machinery handles the rest
    config = dict(config)
    config["source"] = distributed.resolve_source(cache.root, config["source"])
    if config.get("join") is not None:
        join_cfg = dict(config["join"])
        join_cfg["source"] = distributed.resolve_source(cache.root, join_cfg["source"])
        config["join"] = join_cfg

    req = request_from_config(config, target)
    if config.get("join") is not None:
        return analytics.execute_search_join(
            cache,
            req,
            analytics.JoinSpec.from_dict(config["join"]),
            (
                analytics.AggregateSpec.from_dict(config["aggregate"])
                if config.get("aggregate") is not None
                else None
            ),
        )
    # Concurrent compatible searches coalesce into one device dispatch
    # (amortizes the fixed per-dispatch cost; solo requests pass
    # straight through).
    return batching.get_batcher(cache).submit(req)
