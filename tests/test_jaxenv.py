"""Process settings of fastk_tpu.jaxenv: where the compile cache lives, the
device memory budget, and recognising a device out-of-memory error."""

import os
import subprocess
import sys
import textwrap

import pytest

from fastk_tpu import jaxenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env_over) -> str:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_COMPILATION_CACHE", "JAX_PERSISTENT"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env_over)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip()


def test_compile_cache_default_is_fixed_dir_in_checkout():
    got = _run("""
        import fastk_tpu.jaxenv, jax
        print(jax.config.jax_compilation_cache_dir)
    """)
    assert got == os.path.join(REPO, ".jax_cache") == jaxenv.CACHE_DIR


def test_compile_cache_honours_env_dir(tmp_path):
    cache = tmp_path / "cache"
    got = _run("""
        import fastk_tpu.jaxenv, jax, jax.numpy as jnp
        f = jax.jit(lambda x: jnp.sort(x * 3 + 1))
        f(jnp.arange(1000)).block_until_ready()
        print(jax.config.jax_compilation_cache_dir)
    """, JAX_COMPILATION_CACHE_DIR=str(cache),
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")
    assert got == str(cache)
    assert cache.is_dir() and any(cache.iterdir())  # the program landed here


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_budget_reads_gpu_bytes_limit():
    dev = _FakeDevice("gpu", {"bytes_limit": 64_000_000_000,
                              "bytes_in_use": 0})
    assert jaxenv.device_memory_budget(dev) == int(
        64_000_000_000 * (1 - jaxenv.HEADROOM))


def test_budget_on_cpu_is_host_memory():
    import jax

    phys = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    want = int(phys * (1 - jaxenv.HEADROOM))
    assert jaxenv.device_memory_budget(_FakeDevice("cpu", None)) == want
    assert jax.local_devices()[0].platform == "cpu"
    assert jaxenv.device_memory_budget() == want


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_budget_raises_without_a_limit(stats):
    with pytest.raises(RuntimeError, match="no memory limit"):
        jaxenv.device_memory_budget(_FakeDevice("gpu", stats))


def test_is_device_oom():
    assert jaxenv.is_device_oom(RuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
        "60.38GiB."))
    assert not jaxenv.is_device_oom(ValueError("shapes do not match"))
