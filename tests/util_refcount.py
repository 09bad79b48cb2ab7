"""Vectorised numpy k-mer counter: the plain reference that device runs at
full width are compared with (chip_smoke.py), fast enough for 2^26
positions where util_bruteforce's per-k-mer Python loop is not.

Independent of fastk_tpu's compute path. A k-mer (k <= 64) is a 128-bit
value, left-aligned with its first base in the top bits, held as two
uint64 words (hi = bases 0..31, lo = bases 32..63, zero beyond k). Order on
(hi, lo) is the order of the 2-bit strings (a < c < g < t), so the
canonical k-mer is the smaller of a window and its reverse complement on
that pair, and the big-endian bytes of (hi, lo) cut to ceil(k/4) are the
.ktab record bytes. All results are integers and compare exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

HIST_HIGH = 0x7FFF

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"acgt"):
    _CODE[_b] = _i
    _CODE[_b - 32] = _i  # upper case


def codes_of(read) -> np.ndarray:
    """A read (str or bytes) as 2-bit codes; anything not acgt/ACGT -> 4."""
    if isinstance(read, str):
        read = read.encode()
    return _CODE[np.frombuffer(read, dtype=np.uint8)]


def _window_words(c: np.ndarray, k: int, n: int):
    """(hi, lo) of the n windows c[i:i+k] of codes 0..3: bases are packed
    four to a byte first, so a word takes eight shifted ORs."""
    cp = np.concatenate([c, np.zeros(64, dtype=np.uint8)])
    b4 = (cp[:-3] << 6) | (cp[1:-2] << 4) | (cp[2:-1] << 2) | cp[3:]
    words = []
    for base0 in (0, 32):
        nb = max(0, min(k, base0 + 32) - base0)  # bases in this word
        w = np.zeros(n, dtype=np.uint64)
        for m in range((nb + 3) // 4):
            o = base0 + 4 * m
            w |= b4[o: o + n].astype(np.uint64) << np.uint64(56 - 8 * m)
        if nb < 32:
            w &= np.uint64(((1 << 64) - 1) ^ ((1 << (64 - 2 * nb)) - 1))
        words.append(w)
    return words[0], words[1]


def canonical_keys(codes: np.ndarray, k: int):
    """(hi, lo, valid) of every window start of a code stream."""
    if not 1 <= k <= 64:
        raise ValueError("k must be in 1..64")
    n = len(codes) - k + 1
    if n <= 0:
        e = np.zeros(0, dtype=np.uint64)
        return e, e, np.zeros(0, dtype=bool)
    bad = np.concatenate([[0], np.cumsum(codes >= 4)])
    valid = (bad[k:] - bad[:n]) == 0
    c = np.where(codes >= 4, 0, codes).astype(np.uint8)
    fhi, flo = _window_words(c, k, n)
    # the reverse complement of window i is window n-1-i of the complement
    # stream read backwards
    rhi, rlo = _window_words((3 - c)[::-1], k, n)
    rhi, rlo = rhi[::-1], rlo[::-1]
    use_rc = (rhi < fhi) | ((rhi == fhi) & (rlo < flo))
    return (np.where(use_rc, rhi, fhi), np.where(use_rc, rlo, flo), valid)


@dataclass
class RefCount:
    k: int
    hist: np.ndarray       # int64[32768]; hist[c]: uniques of clipped count c
    overflow: int          # instances beyond 32767 of the clipped k-mers
    ninst: int             # valid k-mer instances
    packed: np.ndarray     # uint8[nuniq, ceil(k/4)], sorted .ktab records
    counts: np.ndarray     # uint16[nuniq], clipped at 32767
    profiles: List[np.ndarray]

    def table(self, tmin: int):
        """(packed, counts) of the entries with count >= tmin."""
        keep = self.counts >= tmin
        return self.packed[keep], self.counts[keep]


def count_reads(reads: Sequence[np.ndarray], k: int) -> RefCount:
    """Count the canonical k-mers of reads given as code arrays (codes_of).

    Reads are joined with one invalid separator so no window spans two."""
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
    stream = np.full(int((lens + 1).sum()), 4, dtype=np.uint8)
    for s, r in zip(starts, reads):
        stream[s: s + len(r)] = r
    hi, lo, valid = canonical_keys(stream, k)
    vidx = np.flatnonzero(valid)
    hi, lo = hi[vidx], lo[vidx]
    order = np.lexsort((lo, hi))
    shi, slo = hi[order], lo[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    bounds = np.append(np.flatnonzero(first), len(order))
    run = np.diff(bounds)
    clipped = np.minimum(run, HIST_HIGH)
    hist = np.bincount(clipped, minlength=HIST_HIGH + 1).astype(np.int64)
    overflow = int(run.sum() - clipped.sum())
    # profiles: each valid position takes its k-mer's clipped count
    pos_counts = np.zeros(len(valid), dtype=np.uint16)
    pos_counts[vidx[order]] = np.repeat(clipped, run).astype(np.uint16)
    profiles = [pos_counts[s: s + max(0, int(n) - k + 1)]
                for s, n in zip(starts, lens)]
    uhi, ulo = shi[first], slo[first]
    both = np.stack([uhi, ulo], axis=1).astype(">u8")
    packed = both.view(np.uint8).reshape(len(uhi), 16)[:, : (k + 3) // 4]
    return RefCount(k, hist, overflow, len(vidx), np.ascontiguousarray(packed),
                    clipped.astype(np.uint16), profiles)
