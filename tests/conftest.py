"""Test configuration: run everything on CPU with 8 virtual devices so
sharding/collective tests work without accelerator hardware (SURVEY §4).
Tests marked ``gpu`` need the card and skip here; ``chip_smoke.py`` runs
the same checks on it.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


# A one-shot full-suite run once segfaulted inside XLA-CPU
# backend_compile_and_load ~178 tests in (accumulated backend/compile
# state; every test passes in isolation). Dropping compiled-executable
# caches between modules keeps the backend's code cache from growing
# monotonically across the whole suite.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    try:
        jax.clear_caches()
    except Exception:
        pass
