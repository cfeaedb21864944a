"""Start-up helpers shared by the entry points: the compile-cache
directory and the benchmark's table of published device peaks."""

import os
import sys
import types

import jax
import pytest

from fenix_tpu.utils import jax_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set_is_left_to_jax(cache_config, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jax_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_compile_cache_env_unset_uses_checkout_dir(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert jax_cache.DEFAULT_DIR == want  # fixed: no pid, time or temp name
    assert jax_cache.configure_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_launch_configures_the_cache(monkeypatch):
    from fenix_tpu import launch

    calls = []
    monkeypatch.setattr(launch, "configure_compile_cache", lambda: calls.append("cache"))
    monkeypatch.setattr(launch, "launch", lambda *a: calls.append(("launch", a)))
    monkeypatch.setattr(sys, "argv", ["launch", "/srv/root", "--port", "9"])
    launch.main()
    assert calls == ["cache", ("launch", ("/srv/root", "0.0.0.0", 9))]


def test_bench_peak_table_raises_on_unknown_device():
    sys.path.insert(0, REPO)
    import bench

    h100 = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    assert bench.hbm_bw(h100) == 3.35e12
    for kind in ("NVIDIA A100-SXM4-80GB", "cpu", None):
        with pytest.raises(KeyError):
            bench.hbm_bw(types.SimpleNamespace(device_kind=kind))
