"""Capacity-aware LRU eviction: with FENIX_HBM_BUDGET set, the device
cache drops least-recently-used entries instead of growing without
bound (usable HBM is the binding single-chip limit — exp_16m.py).
Evicted tables must rebuild transparently with identical results."""

import numpy as np
import pyarrow as pa
import pytest

from fenix_tpu.engine import executor as ex
from fenix_tpu.engine import session
from fenix_tpu.io import ingest, table

DIM = 32
ROWS = 2048


def _make(root, name, rng):
    vecs = rng.standard_normal((ROWS, DIM)).astype(np.float32)
    table.make(
        root,
        name,
        pa.table(
            {
                "id": pa.array(np.arange(ROWS)),
                "vector": ingest.numpy_to_fixed_size_list(vecs, pa.float32()),
            }
        ).to_reader(),
    )
    return vecs


def _search(cache, source, target):
    return ex.execute_search(
        cache,
        ex.SearchRequest(
            source=source, column="vector", target=target, metric="l2", maxval=3
        ),
    )


def test_lru_eviction_under_budget(tmp_path, rng, monkeypatch):
    root = str(tmp_path)
    v1 = _make(root, "t1", rng)
    v2 = _make(root, "t2", rng)
    # budget fits ~one table's matrix+aux but not two full working sets
    one_table = ROWS * DIM * 4
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(int(one_table * 1.5)))

    cache = session.DeviceCache(root, block=256, mesh=None)
    out1 = _search(cache, "t1", v1[7])
    assert int(np.asarray(out1.column("id"))[0]) == 7
    assert cache.evictions == 0 or cache.device_bytes() <= int(one_table * 1.5)

    out2 = _search(cache, "t2", v2[9])
    assert int(np.asarray(out2.column("id"))[0]) == 9
    assert cache.evictions > 0, "second table must evict the first"
    assert cache.device_bytes() <= int(one_table * 1.5) + one_table  # newest kept

    # the evicted table rebuilds transparently, identical results
    out1b = _search(cache, "t1", v1[7])
    assert out1.to_pylist() == out1b.to_pylist()


def test_no_budget_no_eviction(tmp_path, rng, monkeypatch):
    monkeypatch.delenv("FENIX_HBM_BUDGET", raising=False)
    root = str(tmp_path)
    v1 = _make(root, "t1", rng)
    v2 = _make(root, "t2", rng)
    cache = session.DeviceCache(root, block=256, mesh=None)
    _search(cache, "t1", v1[0])
    _search(cache, "t2", v2[0])
    assert cache.evictions == 0


def test_recency_protects_hot_entries(tmp_path, rng, monkeypatch):
    """The HOT table (touched most recently) survives; the cold one
    goes."""
    root = str(tmp_path)
    v1 = _make(root, "t1", rng)
    v2 = _make(root, "t2", rng)
    one_table = ROWS * DIM * 4
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(int(one_table * 1.5)))
    cache = session.DeviceCache(root, block=256, mesh=None)
    _search(cache, "t1", v1[0])
    _search(cache, "t2", v2[0])  # evicts t1's entries
    key_t2 = (("t2",), "vector", "matrix")
    assert key_t2 in cache._device, "most recent table must survive"


# -- device-default budget ------------------------------------------------


def test_device_budget_scaled_not_raw(monkeypatch):
    """The device fallback must not plan into bytes_limit raw: a corpus
    that fills JAX's pool leaves no room for a search's transients. The
    default fraction is the one measured on an H100 (utils/hbm.py)."""
    from fenix_tpu.utils import hbm

    monkeypatch.delenv("FENIX_HBM_BUDGET", raising=False)
    monkeypatch.delenv("FENIX_HBM_FRACTION", raising=False)
    monkeypatch.setattr(hbm, "_DEVICE_LIMIT", [63_763_120_128])  # H100 80GB pool
    assert hbm.budget_bytes() == int(63_763_120_128 * hbm.DEFAULT_DEVICE_FRACTION)
    # the largest corpus measured to serve (56 Mi rows × 128, fp32) plans
    # as resident under it (fp32 + 16 B/row aux within 0.9 × budget);
    # the next step measured, 64 Mi rows, does not
    def need(rows):
        return 4 * rows * 128 + 16 * rows

    assert need(56 << 20) <= 0.9 * hbm.budget_bytes() < need(64 << 20)

    monkeypatch.setenv("FENIX_HBM_FRACTION", "0.8")
    assert hbm.budget_bytes() == int(63_763_120_128 * 0.8)

    monkeypatch.setenv("FENIX_HBM_FRACTION", "bogus")
    with pytest.raises(ValueError):
        hbm.budget_bytes()
    monkeypatch.setenv("FENIX_HBM_FRACTION", "1.5")
    with pytest.raises(ValueError):
        hbm.budget_bytes()

    # source counter emitted
    from fenix_tpu.utils.metrics import GLOBAL as METRICS

    monkeypatch.delenv("FENIX_HBM_FRACTION", raising=False)
    hbm.budget_bytes()
    assert METRICS.snapshot().get("hbm.budget_from_device_scaled", 0) >= 1

    # explicit env budget still wins, unscaled
    monkeypatch.setenv("FENIX_HBM_BUDGET", "9e9")
    assert hbm.budget_bytes() == 9_000_000_000


def test_unset_budget_routes_oversized_int8_to_stream(monkeypatch):
    """With NO FENIX_HBM_BUDGET set on a 16 GB-nominal chip, a 12M×768
    int8 residency (~9.4 GB — past the measured ~8-9 GB usable) must
    plan to STREAM, not an OOM-bound INT8 build."""
    import types

    from fenix_tpu.engine import residency
    from fenix_tpu.utils import hbm

    monkeypatch.delenv("FENIX_HBM_BUDGET", raising=False)
    monkeypatch.delenv("FENIX_HBM_FRACTION", raising=False)
    monkeypatch.setattr(hbm, "_DEVICE_LIMIT", [16_000_000_000])

    schema = pa.schema(
        {"vector": pa.list_(pa.float32(), 768)}
    )
    stub_table = types.SimpleNamespace(num_rows=12_000_000, schema=schema)
    cache = types.SimpleNamespace(
        block=16384, mesh=None, host_table=lambda source: stub_table
    )
    req = ex.SearchRequest(
        source="big", column="vector", target=np.zeros((1, 768), np.float32),
        metric="l2", maxval=10, precision="int8",
    )
    assert residency.plan(cache, req) == residency.STREAM
    # raw bytes_limit would have routed INT8 (9.4 GB <= 0.9 * 16 GB)
    monkeypatch.setenv("FENIX_HBM_BUDGET", str(16_000_000_000))
    assert residency.plan(cache, req) == residency.INT8
