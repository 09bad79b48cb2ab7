"""JAX process settings shared by every device-path module: the persistent
compile cache, and the device memory the in-core path may plan to use.

Compile cache. Each (batch size, k) shape compiles its own programs, and
the large sorts take seconds to compile, so compiled executables persist
across processes. ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as
is and no other directory is set in code. Otherwise the cache lives in one
fixed directory inside the checkout (``<repo>/.jax_cache``, listed in
``.gitignore``): the path is part of the cache key, so a directory that
moved from run to run would never hit.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

if (not os.environ.get("JAX_COMPILATION_CACHE_DIR")
        and jax.config.jax_compilation_cache_dir is None):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # the default minimum entry size would skip medium programs; cache
    # every compile that took real time instead
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

# Share of a device's allocatable memory kept free of the in-core plan.
# The plan's per-record footprints (tools/fastk.py) count the arrays the
# pipeline holds and its sort/segment transients; XLA additionally takes
# scratch for sorts and scans and loses some memory to fragmentation.
HEADROOM = 0.10


def device_memory_budget(device=None) -> int:
    """Bytes of device memory the in-core plan may fill on `device`
    (default: the first local device).

    A GPU reports what its allocator may hand out as
    ``memory_stats()["bytes_limit"]`` (three quarters of the card unless
    ``XLA_PYTHON_CLIENT_MEM_FRACTION`` says otherwise). The CPU backend
    allocates from host memory, so there the host's physical memory is the
    limit. Either way HEADROOM is kept free. A device that reports neither
    raises: no size is assumed for a device the program does not know."""
    dev = jax.local_devices()[0] if device is None else device
    if dev.platform == "cpu":
        limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    else:
        stats = dev.memory_stats() or {}
        if "bytes_limit" not in stats:
            raise RuntimeError(
                f"device {dev} ({dev.platform}) reports no memory limit; "
                "cannot plan device memory for it")
        limit = stats["bytes_limit"]
    return int(limit * (1.0 - HEADROOM))


def is_device_oom(exc: BaseException) -> bool:
    """True when `exc` is a device out-of-memory failure. XLA reports an
    allocation its allocator refused as RESOURCE_EXHAUSTED; on an H100 it
    reads "RESOURCE_EXHAUSTED: Out of memory while trying to allocate
    60.38GiB." (checked on the card by chip_smoke.py)."""
    return "RESOURCE_EXHAUSTED" in str(exc)
