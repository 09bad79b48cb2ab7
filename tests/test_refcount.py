"""The vectorised numpy reference counter (util_refcount) agrees with the
per-k-mer brute-force model on tables, counts, instances and profiles."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from util_bruteforce import (  # noqa: E402
    count_kmers, profiles_of, sorted_table)
from util_refcount import codes_of, count_reads  # noqa: E402

from fastk_tpu.formats.ktab import pack_kmer  # noqa: E402


def _reads(seed: int):
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(40):
        n = int(rng.integers(3, 260))
        s = "".join("acgt"[c] for c in rng.integers(0, 4, n))
        if rng.random() < 0.3:  # an N run
            p = int(rng.integers(0, n))
            s = s[:p] + "n" * 3 + s[p + 3:]
        if rng.random() < 0.2:
            s = s.upper()
        reads.append(s)
    reads.append("t" * 90)  # canonicalises to all-a, counted many times
    reads.append("acgt" * 30)  # repeats within one read
    return reads


@pytest.mark.parametrize("k", [12, 32, 40, 64])
def test_refcount_matches_bruteforce(k):
    reads = _reads(k)
    ref = count_reads([codes_of(r) for r in reads], k)
    model = count_kmers(reads, k)
    keys, vals = sorted_table(model)
    want = np.array([pack_kmer(s) for s in keys], dtype=np.uint8)
    assert np.array_equal(ref.packed, want.reshape(len(keys), (k + 3) // 4))
    assert np.array_equal(ref.counts, np.array(vals, dtype=np.uint16))
    assert ref.ninst == sum(model.values())
    assert ref.overflow == 0
    assert int(ref.hist[1:].sum()) == len(model)
    for got, exp in zip(ref.profiles, profiles_of(reads, k, model)):
        assert np.array_equal(got, exp)
    packed, counts = ref.table(3)
    assert np.array_equal(counts, ref.counts[ref.counts >= 3])
    assert len(packed) == int(ref.hist[3:].sum())
