"""bench.py must stay runnable: the driver measures the round with it.
Run its full path (synth -> pack -> device_step -> hist) at toy size on
the CPU mesh and check the histogram accounts for every valid k-mer."""

import importlib.util
import os
import sys

import numpy as np


def _load_bench():
    path = os.path.join(os.path.dirname(__file__), "..", "bench.py")
    spec = importlib.util.spec_from_file_location("bench_mod", path)
    m = importlib.util.module_from_spec(spec)
    sys.modules["bench_mod"] = m
    spec.loader.exec_module(m)
    return m


def test_bench_device_step_small():
    import jax.numpy as jnp

    from fastk_tpu.ops.count import hist_batch
    from fastk_tpu.ops.kmers import pad_needed
    from fastk_tpu.ops.pack import unpack_words

    b = _load_bench()
    K, SIZE, READ_LEN, GENOME = b.K, 1 << 16, 1000, 20_000
    total = SIZE + pad_needed(K)
    pad4 = (-total) % 16

    block, nreads, stride = b.synth_hifi_device(SIZE, GENOME, READ_LEN)
    n = int(block.shape[0])
    full = jnp.concatenate([block, jnp.full(total + pad4 - n, 4, jnp.uint8)])
    packed = np.asarray(
        jnp.asarray(b.pack_codes_device(full)).reshape(-1, 4))
    packed_words = packed.view(np.uint32).ravel()

    sent = np.arange(stride - 1, n, stride, dtype=np.uint32)
    tail = np.arange(n, total, dtype=np.uint32)
    exc = np.concatenate([sent, tail])
    m = ((len(exc) + 4095) // 4096) * 4096
    exc_host = np.full(m, 0xFFFFFFFF, dtype=np.uint32)
    exc_host[: len(exc)] = exc

    codes = unpack_words(jnp.asarray(packed_words), jnp.asarray(exc_host),
                         total)
    out = hist_batch(codes, K, SIZE)
    hist = np.asarray(out["hist"])
    nvalid = int(out["nvalid"])
    assert nvalid == nreads * (READ_LEN - K + 1)
    assert int(hist[1:].sum()) > 0
    # Σ count·hist[count] plus overflow equals the instance total; at toy
    # scale nothing overflows 32767 so the weighted sum is exact
    counts = np.arange(len(hist))
    assert int((counts * hist).sum()) == nvalid


def test_bench_device_line_names_the_device():
    """The line before bench's result names the platform, device kind,
    device count and the card as nvidia-smi reports it."""
    import json

    import jax

    b = _load_bench()
    line = json.loads(b._device_line())
    d = jax.devices()[0]
    assert line["platform"] == d.platform
    assert line["device_kind"] == d.device_kind
    assert line["count"] == len(jax.devices())
    assert line["nvidia_smi"]
