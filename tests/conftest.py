"""Shared test configuration.

Two jobs, both of which must happen BEFORE anything imports jax:

1. Export ``--xla_force_host_platform_device_count=8`` so the whole
   suite sees a fake 8-device host mesh — multi-device sharding tests
   run in-process instead of each needing a subprocess with a custom
   environment (jax locks the device count at first init, which is why
   this lives in conftest rather than a fixture).
2. Install a minimal ``hypothesis`` fallback when the real package is
   not importable (hermetic containers), so property tests still
   collect and run; see tests/_hypothesis_fallback.py for its limits.
"""
import importlib.util
import os
import sys
from pathlib import Path

_DEV_FLAG = "--xla_force_host_platform_device_count=8"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = f"{_flags} {_DEV_FLAG}".strip()

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _path = Path(__file__).resolve().parent / "_hypothesis_fallback.py"
    _spec = importlib.util.spec_from_file_location("hypothesis", _path)
    _mod = importlib.util.module_from_spec(_spec)
    sys.modules["hypothesis"] = _mod
    _spec.loader.exec_module(_mod)
    sys.modules["hypothesis.strategies"] = _mod.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (skips without)")


import pytest  # noqa: E402  (after the env setup above, by design)


@pytest.fixture
def subprocess_env():
    """Hermetic env for tests that spawn a python subprocess with its own
    XLA_FLAGS (device count is locked at first jax init). Pins
    JAX_PLATFORMS so jax never probes accelerator backends — containers
    that bake in libtpu otherwise hang for minutes on TPU-metadata
    fetches."""
    repo = Path(__file__).resolve().parent.parent
    return {
        "PYTHONPATH": str(repo / "src"),
        "PATH": "/usr/bin:/bin",
        "HOME": "/tmp",
        "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu"),
    }
