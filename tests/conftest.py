"""Test configuration: JAX on a virtual 8-device CPU mesh.

Multi-chip sharding tests run against XLA's host-platform device
emulation. Must run before jax is imported. JAX_PLATFORMS defaults to cpu;
the tests marked `gpu` run on a card with JAX_PLATFORMS=cuda (README,
Testing). The compile cache follows the package's own rule
(fastk_tpu.jaxenv): JAX_COMPILATION_CACHE_DIR when set, else the fixed
directory inside the checkout.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest  # noqa: E402

import fastk_tpu.jaxenv  # noqa: E402,F401  (compile cache rule)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none. Decided
    here, at run time, and never at import or collection time, so every
    pytest-xdist worker collects the same tests."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")
    return devs[0]
