"""The device choice (core/device.py), the benchmark's peak table, and the
smoke run's refusal of a machine without a GPU."""

from pathlib import Path

import jax
import pytest

import bench
import chip_smoke
from kinectdepthmapenhancement_tpu.core import device


def test_require_gpu_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="GPU"):
        device.require_gpu()


def test_compile_cache_keeps_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = device.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = Path(chip_smoke.ROOT)
    assert path == str(root / ".jax_cache") == str(device.CACHE_DIR)
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


@pytest.mark.parametrize(
    "backend, onehot", [("cpu", False), ("gpu", True)]
)
def test_table_route_by_backend(backend, onehot):
    assert device.onehot_tables(backend) is onehot


def test_peak_table_finds_h100_by_device_kind():
    bf16, f32, hbm = bench.peak_rates("NVIDIA H100 80GB HBM3")
    assert (bf16, f32, hbm) == (989e12, 67e12, 3.35e12)


def test_peak_table_rejects_unknown_device_kind():
    with pytest.raises(KeyError, match="cpu"):
        bench.peak_rates(jax.devices()[0].device_kind)


def test_chip_smoke_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
