"""2-bit packed host<->device transfer of code streams.

Host->device bandwidth is a first-order cost, so code streams cross packed
4 bases/byte plus a sparse list of exception positions (sentinels/N's), and
are unpacked on device. The same idea as the reference's 2-bit Stuff_Seq
disk streams (split.c:864-989), applied to the host-device link instead of
files.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

import fastk_tpu.jaxenv  # noqa: F401  (compile cache rule)


def pack_stream(codes: np.ndarray, cap_step: int = 1 << 12) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a host code stream (values 0..4) into (packed, exceptions).

    packed: uint8[ceil(n/4)], 4 codes/byte little-position-first; exception
    positions (code >= 4) are packed as 0 and listed in `exceptions`
    (uint32, padded to a multiple of cap_step with 0xFFFFFFFF).
    """
    n = len(codes)
    exc = np.flatnonzero(codes >= 4).astype(np.uint32)
    c = np.where(codes >= 4, 0, codes).astype(np.uint8)
    pad = (-n) % 4
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
    c = c.reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    m = max(cap_step, ((len(exc) + cap_step - 1) // cap_step) * cap_step)
    exc_padded = np.full(m, 0xFFFFFFFF, dtype=np.uint32)
    exc_padded[: len(exc)] = exc
    return packed, exc_padded


@functools.partial(jax.jit, static_argnums=(2,))
def unpack_stream(packed: jnp.ndarray, exceptions: jnp.ndarray, size: int) -> jnp.ndarray:
    """Device: reconstruct the uint8 code stream (sentinels restored)."""
    p = packed.astype(jnp.uint8)
    codes = jnp.stack(
        [p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3], axis=1
    ).reshape(-1)[:size]
    idx = jnp.minimum(exceptions, size)  # 0xFFFFFFFF pads -> dump slot
    codes = jnp.concatenate([codes, jnp.zeros(1, jnp.uint8)])
    codes = codes.at[idx].set(4)
    return codes[:size]


def pack_stream_words(codes: np.ndarray, cap_step: int = 1 << 12
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a host code stream into uint32 words for transfer.

    Same layout as pack_stream's bytes, viewed little-endian as uint32 (so
    code p sits at bits 2*(p%16) of word p//16). Uses the native packer when
    available.
    """
    n = len(codes)
    pad = (-n) % 16
    if pad:
        codes = np.concatenate([codes, np.full(pad, 4, np.uint8)])
    from fastk_tpu import native

    got = native.pack2(codes, ecap=max(cap_step, len(codes)))
    if got is not None:
        packed, exc, ne = got
        m = max(cap_step, ((ne + cap_step - 1) // cap_step) * cap_step)
        exc_padded = np.full(m, 0xFFFFFFFF, dtype=np.uint32)
        exc_padded[:ne] = exc[:ne]
    else:
        packed, exc_padded = pack_stream(codes, cap_step)
    return packed.view(np.uint32), exc_padded


@functools.partial(jax.jit, static_argnums=(2,))
def unpack_words(packed_words: jnp.ndarray, exceptions: jnp.ndarray,
                 size: int) -> jnp.ndarray:
    """Device: uint32-word packed stream -> uint8 codes (sentinels restored)."""
    p = jax.lax.bitcast_convert_type(packed_words, jnp.uint8).reshape(-1)
    return unpack_stream(p, exceptions, size)


def fetch_u16(x) -> np.ndarray:
    """Device uint16 array -> host np.uint16, transferred as uint32 words
    (the bitcast pairs two uint16 lanes per word, both sides
    little-endian)."""
    n = int(x.shape[0])
    if n % 2:
        return np.asarray(x)
    w = jax.lax.bitcast_convert_type(x.reshape(n // 2, 2), jnp.uint32)
    return np.asarray(w).view(np.uint16)
