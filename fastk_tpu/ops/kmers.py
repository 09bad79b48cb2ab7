"""Device-side canonical k-mer key construction (JAX, static shapes).

A k-mer key is W = ceil(k/16) uint32 words, 16 bases per word, 2 bits per
base, big-endian within and across words, last word left-aligned and
zero-padded — so lexicographic word-tuple order equals the byte order of the
on-disk .ktab packing (reference packing: README.md table spec; the
reference's byte-at-a-time canonical compare is count.c:439-510, here done
word-parallel over all positions at once).

All positions of a code stream are processed in one fixed shape [S]: word
arrays are built bit-parallel from 4-base uint8 groups (see canonical_kmers)
instead of the reference's per-base rolling scalar loop (split.c:1136-1320)
— that loop is inherently sequential; this form is pure VPU work that XLA
fuses and vectorizes.

Invalid positions (windows containing a non-acgt code or crossing a read
boundary sentinel) get all-zero words and an invalid flag that sorts last.
"""

from __future__ import annotations

import functools


import jax
import jax.numpy as jnp

import fastk_tpu.jaxenv  # noqa: F401  (compile cache rule)
import numpy as np


def nwords(k: int) -> int:
    return (k + 15) // 16


def pad_needed(k: int) -> int:
    """Host must pad the code stream with at least this many sentinel codes
    beyond the last window position."""
    return k + 16


def _slice(c: jnp.ndarray, off: int, size: int) -> jnp.ndarray:
    return jax.lax.dynamic_slice(c, (off,), (size,))


def _pack4_fwd(c: jnp.ndarray, n: int) -> jnp.ndarray:
    """A[p] = 2-bit pack of codes p..p+3, base p in the high bits (uint8)."""
    return ((( _slice(c, 0, n) & 3) << 6)
            | ((_slice(c, 1, n) & 3) << 4)
            | ((_slice(c, 2, n) & 3) << 2)
            | (_slice(c, 3, n) & 3))


def _pack4_rc(c: jnp.ndarray, n: int) -> jnp.ndarray:
    """B[p] = 2-bit pack of complemented codes p+3..p, base p+3 in the high
    bits (the reverse-complement of a 4-base group, uint8)."""
    return ((((3 - _slice(c, 3, n)) & 3) << 6)
            | (((3 - _slice(c, 2, n)) & 3) << 4)
            | (((3 - _slice(c, 1, n)) & 3) << 2)
            | ((3 - _slice(c, 0, n)) & 3))


def _word16(groups: jnp.ndarray, off: int, size: int) -> jnp.ndarray:
    """16-base uint32 word at each position from 4-base uint8 groups."""
    return ((_slice(groups, off, size).astype(jnp.uint32) << 24)
            | (_slice(groups, off + 4, size).astype(jnp.uint32) << 16)
            | (_slice(groups, off + 8, size).astype(jnp.uint32) << 8)
            | _slice(groups, off + 12, size).astype(jnp.uint32))


def _word16_rc(groups: jnp.ndarray, off: int, size: int) -> jnp.ndarray:
    """16-base rc uint32 word: group order reverses (base off+15 must land
    in the top bit-pair and each B group already reverses within itself)."""
    return ((_slice(groups, off + 12, size).astype(jnp.uint32) << 24)
            | (_slice(groups, off + 8, size).astype(jnp.uint32) << 16)
            | (_slice(groups, off + 4, size).astype(jnp.uint32) << 8)
            | _slice(groups, off, size).astype(jnp.uint32))


@functools.partial(jax.jit, static_argnums=(1, 2))
def canonical_kmers(codes: jnp.ndarray, k: int, size: int):
    """Canonical k-mer keys for every window start in [0, size).

    codes: uint8/uint32 [>= size + k + 16], values 0..3 valid, >=4 invalid.

    Returns (words, invalid):
      words:   tuple of W uint32 [size] — canonical key, zeroed when invalid
      invalid: uint32 [size] — 1 where the window is not a valid k-mer

    Built in two levels to cut HBM traffic ~4x vs 32 single-base ORs per
    word: 4-base uint8 groups (A = forward, B = reverse-complement) then 4
    byte-shifted ORs per 16-base word. The last word, holding L = k mod 16
    bases left-aligned, is carved from a full 16-base word by masking (fwd:
    top 2L bits are exactly its L bases; rc: the LOW 2L bits of the
    full-window rc word at offset 0 are bases p..p+L-1 reversed, shifted up).
    """
    c = codes.astype(jnp.uint8)
    W = nwords(k)
    L = k - 16 * (W - 1)  # bases in the last word, 1..16
    ng = size + k  # group positions needed (offsets up to k-4+...)

    A = _pack4_fwd(c, ng)
    B = _pack4_rc(c, ng)

    fwd = [_word16(A, 16 * w, size) for w in range(W - 1)]
    f_full = _word16(A, 16 * (W - 1), size)
    if L == 16:
        fwd.append(f_full)
    else:
        fwd.append(f_full & jnp.uint32(((1 << (2 * L)) - 1) << (32 - 2 * L)))

    rc = [_word16_rc(B, k - 16 * (w + 1), size) for w in range(W - 1)]
    r_full = _word16_rc(B, 0, size)
    if L == 16:
        rc.append(r_full)
    else:
        rc.append((r_full & jnp.uint32((1 << (2 * L)) - 1)) << (32 - 2 * L))

    # lexicographic fwd vs rc
    take_rc = jnp.zeros(size, jnp.int32)
    for w in range(W):
        cmp = jnp.where(fwd[w] < rc[w], -1, jnp.where(fwd[w] > rc[w], 1, 0))
        take_rc = jnp.where(take_rc != 0, take_rc, cmp)
    take_rc = take_rc > 0

    # validity: no invalid code inside the window
    bad = (_slice(c, 0, size + k) >= 4).astype(jnp.int32)
    cb = jnp.cumsum(bad)
    cb = jnp.concatenate([jnp.zeros(1, jnp.int32), cb])
    invalid = (cb[k:size + k] - cb[:size]) > 0

    words = tuple(
        jnp.where(invalid, 0, jnp.where(take_rc, rc[w], fwd[w])) for w in range(W)
    )
    return words, invalid.astype(jnp.uint32)


def words_to_packed(words: np.ndarray, k: int) -> np.ndarray:
    """Host: (n, W) uint32 canonical words -> (n, ceil(k/4)) uint8 .ktab bytes."""
    kb = (k + 3) // 4
    if words.shape[0] == 0:
        return np.zeros((0, kb), dtype=np.uint8)
    be = np.ascontiguousarray(words.astype(">u4"))
    return be.view(np.uint8).reshape(words.shape[0], -1)[:, :kb]


def packed_to_words(packed: np.ndarray, k: int) -> np.ndarray:
    """Host: (n, ceil(k/4)) uint8 .ktab bytes -> (n, W) uint32 words."""
    n = packed.shape[0]
    W = nwords(k)
    buf = np.zeros((n, 4 * W), dtype=np.uint8)
    buf[:, : packed.shape[1]] = packed
    return buf.view(">u4").astype(np.uint32).reshape(n, W)
