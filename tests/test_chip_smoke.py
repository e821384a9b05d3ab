"""Runtime plumbing: the compile-cache helper, chip_smoke.py's device
guard on a CPU backend, and (card only) chip_smoke.py itself."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from multiviewstitch_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_var_is_used_and_nothing_else_set(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there and
    the checkout's default directory gets nothing."""
    default = ROOT / ".jax_cache"
    had = set(os.listdir(default)) if default.exists() else set()
    code = (
        "import jax\n"
        "from multiviewstitch_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "before = jax.config.values.copy()\n"
        "print(enable_compile_cache())\n"
        "assert jax.config.values == before\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 2 + 1)(jax.numpy.arange(7.0))"
        ".block_until_ready()\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == str(tmp_path)
    assert any(tmp_path.iterdir())
    now = set(os.listdir(default)) if default.exists() else set()
    assert now == had


def test_require_gpu_refuses_cpu_backend():
    import chip_smoke
    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code != 0


def test_chip_smoke_exits_nonzero_without_result_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_card():
    """Runs every single-card phase of chip_smoke.py on the GPU."""
    if (os.environ.get("JAX_PLATFORMS", "").lower() == "cpu" or
            shutil.which("nvidia-smi") is None):
        pytest.skip("needs an NVIDIA GPU: on the card run "
                    "`python -m pytest -m gpu tests/test_chip_smoke.py`")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=1500)
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-4000:])
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
