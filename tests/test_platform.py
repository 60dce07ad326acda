"""Backend choice, the compile-cache helper, and the chip smoke script's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from tdoa_tpu.utils import platform as plat_mod
from tdoa_tpu.utils.platform import (
    compilation_cache_dir,
    select_platform,
    setup_compilation_cache,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_select_cpu_works():
    assert select_platform("cpu") == "cpu"


def test_select_gpu_raises_without_gpu():
    with pytest.raises(RuntimeError, match="TDOA_TPU_PLATFORM=cpu"):
        select_platform("gpu")


@pytest.mark.parametrize("bad", ["cuda", "metal", ""])
def test_select_rejects_unknown_platform(bad):
    with pytest.raises(ValueError, match="platform must be one of"):
        select_platform(bad)


def _cli_env(**kv):
    env = dict(os.environ)
    env.pop("TDOA_TPU_PLATFORM", None)
    env.update(PYTHONPATH=REPO, **kv)
    return env


@pytest.mark.parametrize("setting", ["gpu", None])
def test_cli_without_gpu_exits_nonzero(setting, tmp_path):
    """TDOA_TPU_PLATFORM=gpu — and the default, which is gpu — fails on
    a host without a GPU, naming the CPU setting; it never carries on
    on the CPU."""
    env = _cli_env() if setting is None else _cli_env(
        TDOA_TPU_PLATFORM=setting)
    r = subprocess.run(
        [sys.executable, "-m", "tdoa_tpu.cli.simple_corr", "--n", "16384"],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=str(tmp_path),
    )
    assert r.returncode != 0
    assert "TDOA_TPU_PLATFORM=cpu" in r.stderr


def test_cli_cpu_setting_runs(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "tdoa_tpu.cli.simple_corr", "--n", "16384"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=_cli_env(TDOA_TPU_PLATFORM="cpu"),
    )
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize(
    "env_dir, platform, want",
    [
        ("/some/cache", "gpu", "/some/cache"),
        ("/some/cache", "cpu", "/some/cache"),
        ("", "gpu", os.path.join(REPO, ".jax_cache")),
        ("", "cpu", None),
    ],
)
def test_compilation_cache_dir(monkeypatch, env_dir, platform, want):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    assert compilation_cache_dir(platform) == want


def test_repo_cache_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_setup_cache_uses_the_variable(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache lands there and the
    helper sets no other directory."""
    where = str(tmp_path / "cc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", where)
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs,
           jax.config.jax_persistent_cache_min_entry_size_bytes)
    try:
        assert setup_compilation_cache("cpu") == where
        assert jax.config.jax_compilation_cache_dir == where
        assert os.path.isdir(where)
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])
        jax.config.update("jax_persistent_cache_min_entry_size_bytes",
                          old[2])


def test_setup_cache_leaves_cpu_uncached(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert setup_compilation_cache("cpu") is None
    assert jax.config.jax_compilation_cache_dir == before


def test_gpu_name_power_limit_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    assert plat_mod.gpu_name_power_limit() is None


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """No GPU: non-zero exit and no result line — both in the checkout
    and in a directory holding chip_smoke.py and nothing else."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, script], capture_output=True, text=True,
        env=env, timeout=300, cwd=str(tmp_path),
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
