"""Device-derived routing budgets and the compile-cache location."""

import os

import numpy as np
import pytest

from kbbq_tpu.utils import compile_cache, mem

GiB = 1 << 30


class FakeDevice:
    """Stands in for a jax Device: platform, kind and memory_stats."""

    def __init__(self, platform="gpu", bytes_limit=None):
        self.platform = platform
        self.device_kind = "fake card"
        self._limit = bytes_limit

    def memory_stats(self):
        if self._limit is None:
            return {"bytes_in_use": 0}
        return {"bytes_limit": self._limit, "bytes_in_use": 0}


@pytest.mark.parametrize("name,sixteenths", [
    ("resident", 6), ("replicated", 4), ("dense_build", 3),
    ("window_cache", 2)])
def test_budget_is_a_share_of_bytes_limit(name, sixteenths):
    dev = FakeDevice(bytes_limit=64 * GiB)
    assert mem.device_budget(name, dev) == 64 * GiB * sixteenths // 16
    # the CPU backend keeps the same shares of 16 GiB (the test sizes)
    assert mem.device_budget(name, FakeDevice("cpu")) == \
        sixteenths * GiB == mem.CPU_BUDGETS[name]


def test_accelerator_without_bytes_limit_is_an_error():
    with pytest.raises(RuntimeError, match="bytes_limit"):
        mem.device_budget("resident", FakeDevice("gpu", None))


def test_budget_defaults_to_the_first_jax_device():
    import jax
    assert jax.devices()[0].platform == "cpu"
    assert mem.device_budget("dense_build") == mem.CPU_BUDGETS["dense_build"]


def _tiny_arrays(n=64, L=40):
    from kbbq_tpu.io.batcher import ReadArrays
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(n, L)).astype(np.int8)
    quals = np.full((n, L), 30, np.int8)
    return ReadArrays(codes, quals, np.ones((n, L), bool),
                      np.zeros(n, np.int32), np.arange(n) % 2 == 1)


@pytest.mark.parametrize("limit,route", [
    (80 * GiB, "resident"), (16 << 10, "batched")])
def test_single_device_route_follows_bytes_limit(monkeypatch, limit, route):
    """64 reads x 40 bases x 6 B = 15 KiB: resident under an 80 GB card's
    budget, batched under a 16 KiB one."""
    from kbbq_tpu.pipeline import RecalConfig, recalibrate, resident

    monkeypatch.setattr(mem, "_default_device",
                        lambda: FakeDevice(bytes_limit=limit))
    monkeypatch.setattr(resident, "recalibrate_arrays_resident",
                        lambda *a, **k: "resident")
    monkeypatch.setattr(recalibrate, "recalibrate_arrays",
                        lambda *a, **k: "batched")
    got = recalibrate.run_pipeline(_tiny_arrays(),
                                   RecalConfig(k=16, coverage=10.0,
                                               batch_size=16))
    assert got == route


@pytest.mark.parametrize("limit,layout", [
    (80 * GiB, "replicated"), (256 << 10, "sharded")])
def test_auto_bloom_layout_follows_bytes_limit(monkeypatch, limit, layout):
    """Two 2^16-slot filters (128 KiB) fit 4/16 of 80 GB, not of 256 KiB."""
    from kbbq_tpu.parallel import resident_sharded, sharded_bloom
    from kbbq_tpu.pipeline import RecalConfig, recalibrate

    monkeypatch.setattr(mem, "_default_device",
                        lambda: FakeDevice(bytes_limit=limit))
    monkeypatch.setattr(resident_sharded,
                        "recalibrate_arrays_resident_sharded",
                        lambda *a, **k: "replicated")
    monkeypatch.setattr(sharded_bloom, "sharded_bloom_recalibrate_arrays",
                        lambda *a, **k: "sharded")
    got = recalibrate.run_pipeline(
        _tiny_arrays(), RecalConfig(k=16, coverage=10.0, batch_size=16),
        devices=2, bloom_layout="auto")
    assert got == layout


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    import jax
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []                  # JAX reads the variable itself


def test_compile_cache_default_is_inside_the_checkout(monkeypatch,
                                                      tmp_path):
    import jax
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    monkeypatch.chdir(tmp_path)         # independent of the cwd
    assert compile_cache.enable_compile_cache() == want
    assert compile_cache.enable_compile_cache() == want   # fixed
    assert calls == [("jax_compilation_cache_dir", want)] * 2
