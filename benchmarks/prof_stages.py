"""Microbenchmark of the count_batch stages on the device.

Every timed function returns a scalar that is fetched to the host, so the
timing covers execution; the `null` baseline's round trip is subtracted.
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from fastk_tpu.ops.kmers import canonical_kmers, pad_needed
from fastk_tpu.ops.count import sort_records, segmented_count, count_batch
from fastk_tpu.ops.pack import pack_stream, unpack_stream

K = 40
SIZE = 1 << 26


def timeit(name, fn, *args, n=3):
    fn(*args)  # compile + warm
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args)
        float(out)  # force full sync via scalar D2H
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))
    print(f"{name:38s} {t*1e3:9.1f} ms   {SIZE/t/1e6:8.1f} Mpos/s")
    return t


def main():
    rng = np.random.default_rng(0)
    total = SIZE + pad_needed(K)
    codes_host = rng.integers(0, 4, size=total, dtype=np.uint8)
    codes_host[:: 20001] = 4
    codes_host[SIZE:] = 4
    packed_host, exc_host = pack_stream(codes_host)

    packed = jnp.asarray(packed_host)
    exc = jnp.asarray(exc_host)

    timeit("null (sync latency)", jax.jit(lambda p: jnp.sum(p[:8])), packed)

    f_unpack = jax.jit(lambda p, e: jnp.sum(unpack_stream(p, e, total)[::65536]
                                            .astype(jnp.int32)))
    timeit("unpack_stream", f_unpack, packed, exc)

    codes = jax.jit(lambda p, e: unpack_stream(p, e, total))(packed, exc)

    f_canon = jax.jit(
        lambda c: canonical_kmers(c, K, SIZE)[0][0][::65536].astype(jnp.int32).sum())
    timeit("canonical_kmers", f_canon, codes)

    words, invalid = jax.jit(lambda c: canonical_kmers(c, K, SIZE))(codes)

    f_sort = jax.jit(
        lambda w, i: sort_records(w, i)[0][0][::65536].astype(jnp.int32).sum())
    timeit("sort_records (1+3 keys)", f_sort, words, invalid)

    f_sort1 = jax.jit(lambda w: jax.lax.sort((w,), num_keys=1)[0][::65536]
                      .astype(jnp.int32).sum())
    timeit("lax.sort 1 key (ref point)", f_sort1, words[0])

    f_sort3 = jax.jit(lambda w: jax.lax.sort(w, num_keys=3)[0][::65536]
                      .astype(jnp.int32).sum())
    timeit("lax.sort 3 keys no values", f_sort3, words)

    s_words, s_inv, _ = jax.jit(lambda w, i: sort_records(w, i))(words, invalid)

    f_seg = jax.jit(lambda w, i: segmented_count(w, i, SIZE, want_hist=True)
                    ["hist"].sum())
    timeit("segmented_count(hist+compaction)", f_seg, s_words, s_inv)

    def seg_hist_only(s_words, s_inv):
        starts = jnp.zeros(SIZE, dtype=bool)
        for w in s_words:
            starts = starts | (w != jnp.roll(w, 1))
        starts = (starts | (s_inv != jnp.roll(s_inv, 1))).at[0].set(True)
        idx = jnp.arange(SIZE, dtype=jnp.int32)
        start_of = jax.lax.cummax(jnp.where(starts, idx, 0))
        nxt = jnp.where(starts, idx, SIZE)
        end_of = jnp.concatenate([
            jax.lax.cummin(nxt[::-1])[::-1][1:], jnp.full((1,), SIZE, jnp.int32)
        ])
        seg_len = end_of - start_of
        use = starts & (s_inv == 0)
        clipped = jnp.minimum(seg_len, 0x7FFF)
        hist = jnp.zeros(0x8000, jnp.int32).at[
            jnp.where(use, clipped, 0)].add(jnp.where(use, 1, 0))
        return hist.sum()

    timeit("seg hist only (no compaction)", jax.jit(seg_hist_only), s_words, s_inv)

    f_full = jax.jit(lambda c: count_batch(c, K, SIZE, False, True)["hist"].sum())
    timeit("count_batch full (hist)", f_full, codes)


if __name__ == "__main__":
    main()
