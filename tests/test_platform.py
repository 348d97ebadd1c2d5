"""The platform table (swtpu.device), the compile-cache helper, and the
entry points that must refuse to report without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from swtpu.device import CACHE_DIR, PLANS, enable_compile_cache, kernel_plan, stream_count

REPO = Path(__file__).resolve().parent.parent


def test_platform_table_gpu_never_interprets():
    plan = kernel_plan("gpu")
    assert plan.backend == "stream"
    assert plan.interpret is False
    assert plan.block & (plan.block - 1) == 0
    assert plan.streams % plan.block == 0


def test_platform_table_cpu_runs_scan_interpreted():
    plan = kernel_plan("cpu")
    assert plan.backend == "scan"
    assert plan.interpret is True


@pytest.mark.parametrize("platform", ["metal", "rocm", ""])
def test_platform_table_refuses_unknown_platform(platform):
    with pytest.raises(ValueError, match="no scoring kernel"):
        kernel_plan(platform)


def test_platform_table_default_is_jax_backend():
    import jax

    assert kernel_plan() == PLANS[jax.default_backend()]


@pytest.mark.parametrize(
    "n_reads,want", [(0, 8), (1, 8), (8, 8), (9, 8), (10**6, 8)]
)
def test_stream_count_cpu(n_reads, want):
    assert stream_count(n_reads, kernel_plan("cpu")) == want


@pytest.mark.parametrize("n_reads", [1, 1000, 1 << 16, 1 << 20])
def test_stream_count_gpu_whole_blocks(n_reads):
    plan = kernel_plan("gpu")
    n = stream_count(n_reads, plan)
    assert n % plan.block == 0 and 0 < n <= plan.streams
    assert n >= min(n_reads, plan.streams)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing is set


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == str(REPO / ".jaxcache")
    assert CACHE_DIR == REPO / ".jaxcache"
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jaxcache"))]


def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass


def test_chip_smoke_fails_without_gpu():
    proc = _run_cpu(["chip_smoke.py"], REPO)
    _no_result(proc)
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    _no_result(_run_cpu(["chip_smoke.py"], tmp_path))


def test_bench_fails_without_gpu():
    proc = _run_cpu(["bench.py", "--reads", "64"], REPO)
    _no_result(proc)
    assert "no GPU" in proc.stderr
