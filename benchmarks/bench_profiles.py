"""Secondary benchmark: the fused `-t -p` job (table + per-read profiles).

Measures the DEVICE path per batch: count + merge-quality uniques plus the
profile sort-merge join, on the 50X-HiFi-like synthetic set. D2H included:
the nvalid scalar + an 8-element pos_counts probe (forces execution). The
bulk uint16 pos_counts D2H (0.5 B/base) is excluded: this times the device
path alone.

Prints one JSON line like bench.py (not the driver headline)."""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASELINE = 8.3e7 / 2  # FastK -t -p runs ~half its histogram-only speed


def main():
    import jax
    import jax.numpy as jnp

    import bench as B
    from fastk_tpu.ops.count import HIST_HIGH  # noqa: F401
    from fastk_tpu.ops.kmers import pad_needed

    import os
    K = 40
    # 2^24 is the measured batch-size optimum (benchmarks/README round 3)
    SIZE = int(os.environ.get("FASTK_BENCH_SIZE", str(1 << 24)))
    total = SIZE + pad_needed(K)
    block, nreads, stride = B.synth_hifi_device(
        SIZE, max(1 << 16, SIZE // 33), B.READ_LEN)
    n = int(block.shape[0])
    codes = jnp.concatenate([block, jnp.full(total - n, 4, jnp.uint8)])

    from fastk_tpu.ops.count import count_batch

    @jax.jit
    def step(codes):
        # the fused single-batch -t -p path (pipeline._count_single_fused)
        res = count_batch(codes, K, SIZE, True, True)
        return res["nvalid"], res["pos_counts"]

    nvalid, pc = step(codes)
    _ = int(nvalid); _ = np.asarray(pc[:8])

    ts = []
    for _i in range(3):
        t0 = time.perf_counter()
        nvalid, pc = step(codes)
        _ = int(nvalid); _ = np.asarray(pc[:8])
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))
    bases = nreads * B.READ_LEN
    value = bases / t
    print(json.dumps({
        "metric": "bases/sec/chip: fused 40-mer count+table+profile join",
        "value": round(value),
        "unit": "bases/sec",
        "vs_baseline": round(value / BASELINE, 3),
    }))


if __name__ == "__main__":
    main()
