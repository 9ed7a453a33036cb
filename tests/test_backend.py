"""The backend choice, compile-cache placement, the peak table and the
chip smoke script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from parallel_implementation_of_string_matching_algorithms_opencl_tpu import (
    match,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.models import (
    backend,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils import (
    cache,
)
from parallel_implementation_of_string_matching_algorithms_opencl_tpu.utils.config import (
    MatchConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _platform(monkeypatch, name):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: name)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_supported_platforms_take_the_plain_path(monkeypatch, platform):
    _platform(monkeypatch, platform)
    assert backend.execution_path() == backend.PLAIN


@pytest.mark.parametrize("platform", ["metal", "rocm", "interpreter"])
def test_unknown_platform_raises(monkeypatch, platform):
    _platform(monkeypatch, platform)
    with pytest.raises(RuntimeError, match=platform):
        backend.execution_path()


@pytest.mark.parametrize("algo,capacity", [
    ("naive", 4101), ("rabin_karp", 4102), ("kmp", 4103),
    ("boyer_moore", 4099),
])
def test_match_on_unknown_platform_raises(monkeypatch, algo, capacity):
    _platform(monkeypatch, "metal")
    with pytest.raises(RuntimeError, match="metal"):
        # A capacity no other test uses forces a fresh trace.
        match(b"xyzxyz" * 40, b"zx", algo=algo, capacity=capacity)


def test_multi_pattern_match_on_unknown_platform_raises(monkeypatch):
    _platform(monkeypatch, "metal")
    with pytest.raises(RuntimeError, match="metal"):
        match(b"xyzxyz" * 40, [b"zx", b"yz"], algo="rabin_karp",
              capacity=4104)


@pytest.mark.parametrize("option,value", [
    ("use_pallas", "on"), ("use_pallas", "off"), ("interpret", True),
])
def test_kernel_options_are_refused(option, value):
    # No kernel is left to select, so the options that chose one are gone:
    # passing one raises instead of being ignored.
    with pytest.raises(TypeError, match=option):
        MatchConfig(**{option: value})
    with pytest.raises(TypeError, match=option):
        match(b"abcabcabd" * 50, b"abd", algo="kmp", **{option: value})


def test_compile_cache_uses_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.compile_cache_dir()
    assert path == os.path.join(cache.CHECKOUT, ".jax_cache")
    assert os.path.isdir(os.path.join(
        cache.CHECKOUT,
        "parallel_implementation_of_string_matching_algorithms_opencl_tpu",
    ))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_sets_jax(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert cache.enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_peak_table_has_the_h100():
    sys.path.insert(0, REPO)
    import bench

    row = bench.peak("NVIDIA H100 80GB HBM3")
    assert row["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in row["source"]


def test_peak_table_rejects_unknown_devices():
    sys.path.insert(0, REPO)
    import bench

    with pytest.raises(ValueError, match="no published peaks"):
        bench.peak("Some Other Accelerator")


def _run_smoke(cwd, extra_env):
    env = dict(os.environ, **extra_env)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_gpu():
    out = _run_smoke(REPO, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
