"""Entry points on a host without a GPU, and the compile-cache placement.

A measurement or a GPU run that finds no card must fail, not fall back to
the CPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fccf_pcr_tpu.utils import cache

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, env=env,
        cwd=cwd, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "PHASE" not in out.stdout  # stopped before compiling anything
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_fails_without_gpu():
    out = _run(["bench.py"])
    assert out.returncode != 0
    assert "measures the GPU" in out.stderr
    assert "pairs/s" not in out.stdout


def test_evaluate_defaults_to_gpu_and_fails_without_one():
    out = _run(["tools/evaluate.py", "--seeds", "1"])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert "pairs/s" not in out.stdout


def test_cli_module_defaults_to_gpu_and_fails_without_one():
    out = _run(["-m", "fccf_pcr_tpu", "src.ply", "tar.ply", "0.1"])
    assert out.returncode != 0
    assert "no GPU" in out.stderr


def test_cli_device_gpu_fails_on_cpu_host():
    from fccf_pcr_tpu import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["src.ply", "tar.ply", "0.1", "--device", "gpu"])
    assert e.value.code != 0


def test_cache_honours_env_variable(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert cache.compile_cache_dir("gpu", env) is None
    assert cache.compile_cache_dir("cpu", env) is None


def test_cache_default_is_fixed_in_checkout():
    assert cache.compile_cache_dir("gpu", {}) == ROOT / ".jax_cache"
    cpu = cache.compile_cache_dir("cpu", {})
    assert cpu.parent == ROOT / ".jax_cache"
    assert cpu == cache.compile_cache_dir("cpu", {})  # stable across calls
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_setup_compile_cache_sets_nothing_when_env_set(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
