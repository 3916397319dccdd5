"""The backend module (rbl/backend.py): the one place that knows backend
names — the interpret rule, the GPU requirement, the device summary and
the compile-cache directory."""

import os
import subprocess
import sys

import jax
import pytest

from rbl import backend


class _Dev:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


@pytest.mark.parametrize("platform,expect", [("cpu", True), ("gpu", False)])
def test_interpret_mode_rule(monkeypatch, platform, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert backend.interpret_mode() is expect


def test_interpret_mode_rejects_other_backends(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        backend.interpret_mode()


def test_require_gpu_fails_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU found"):
        backend.require_gpu()


def test_require_gpu_returns_gpu_devices(monkeypatch):
    devs = [_Dev("gpu", "NVIDIA H100 80GB HBM3")] * 4
    monkeypatch.setattr(jax, "devices", lambda: devs)
    assert backend.require_gpu() == devs
    assert backend.device_summary() == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
    }


def test_device_summary_on_cpu():
    s = backend.device_summary()
    assert s["platform"] == "cpu" and s["count"] == len(jax.devices())


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_fixed_checkout_path(monkeypatch,
                                                          tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(backend.__file__)))
    assert backend.compile_cache_dir() == os.path.join(root, ".jax_cache")
    # independent of the working directory...
    monkeypatch.chdir(tmp_path)
    assert backend.compile_cache_dir() == os.path.join(root, ".jax_cache")
    # ...and of the process: a fresh interpreter resolves the same path
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = root
    out = subprocess.run(
        [sys.executable, "-c",
         "from rbl.backend import compile_cache_dir; "
         "print(compile_cache_dir())"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert out.stdout.strip() == os.path.join(root, ".jax_cache")


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert backend.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert jax.config.jax_persistent_cache_min_compile_time_secs <= 0.1
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", old[1]
        )


def test_donate_allowlist(monkeypatch):
    """RBL_NO_DONATION=1 (the cached-CPU-run allowlist) makes donate()
    return no argnums."""
    monkeypatch.delenv("RBL_NO_DONATION", raising=False)
    assert backend.donate(1) == (1,)
    monkeypatch.setenv("RBL_NO_DONATION", "1")
    assert backend.donate(0, 2) == ()
