"""Native host runtime (C++ via ctypes) vs numpy oracles."""

import numpy as np
import pytest

from fenix_tpu import native


def test_pack_rows(rng):
    x = rng.standard_normal((100, 16)).astype(np.float32)
    out = native.pack_rows(x, 128)
    np.testing.assert_array_equal(out[:100], x)
    assert (out[100:] == 0).all()


def test_pack_rows_fill_neg1(rng):
    x = rng.integers(0, 100, 50).astype(np.int32)
    out = native.pack_rows(x, 64, 0xFF)
    np.testing.assert_array_equal(out[:50], x)
    assert (out[50:] == -1).all()


def test_gather_rows(rng):
    x = rng.standard_normal((500, 32)).astype(np.float32)
    idx = rng.integers(0, 500, 200)
    np.testing.assert_array_equal(native.gather_rows(x, idx), x[idx])


def test_hash_partition_matches_device(rng):
    import jax.numpy as jnp

    from fenix_tpu.ops import relational

    keys = rng.integers(0, 1 << 31, 10_000).astype(np.int64)
    parts, counts = native.hash_partition(keys, 16)
    dev = np.asarray(relational.hash_partition(jnp.asarray(keys), 16))
    np.testing.assert_array_equal(parts, dev)
    np.testing.assert_array_equal(counts, np.bincount(parts, minlength=16))


def test_partition_scatter_stable(rng):
    x = rng.standard_normal((300, 8)).astype(np.float32)
    keys = rng.integers(0, 1000, 300).astype(np.int64)
    parts, counts = native.hash_partition(keys, 4)
    out, offsets = native.partition_scatter(x, parts, counts)
    order = np.argsort(parts, kind="stable")
    np.testing.assert_array_equal(out, x[order])
    assert offsets[-1] == 300


def test_row_score_matches_numpy(rng):
    """Fused scorer == gather-then-BLAS to f32 sum-order tolerance, for
    both dtypes, including out-of-order positions."""
    from fenix_tpu import native

    n_rows, d = 500, 16
    pos = rng.integers(0, n_rows, 300)
    q = rng.standard_normal(d).astype(np.float32)
    mul = rng.standard_normal(n_rows).astype(np.float32)
    add = rng.standard_normal(n_rows).astype(np.float32)
    for rows in (
        rng.standard_normal((n_rows, d)).astype(np.float32),
        rng.integers(-127, 128, (n_rows, d)).astype(np.int8),
    ):
        want = (rows[pos].astype(np.float32) @ q) * mul[pos] + add[pos]
        got = native.row_score(rows, pos, q, mul, add)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_library_builds_at_first_use(tmp_path, monkeypatch):
    """No build output is committed: the first use compiles the source
    into the build directory under a source-keyed name and loads it."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    path = native.lib_path()
    assert path.startswith(str(tmp_path)) and not (tmp_path / "build").exists()

    lib = native._load()
    assert lib is not None and lib.fenix_version() > 0
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        path.rsplit("/", 1)[1]
    ]  # the temporary file was renamed, not left behind
    assert native.build() == path  # built once; the second call only finds it


def test_no_compiler_falls_back_to_numpy(tmp_path, monkeypatch, rng):
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native._load() is None and not native.available()
    x = rng.standard_normal((50, 8)).astype(np.float32)
    np.testing.assert_array_equal(native.gather_rows(x, np.arange(10)), x[:10])
