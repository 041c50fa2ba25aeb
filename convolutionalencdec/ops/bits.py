"""Bit packing/unpacking utilities.

Vectorized replacement for the reference's bit-twiddling layer
(src/convHelpers.{h,c}).  All byte<->bit conversions follow the reference's
transmission convention: within a byte the MSb is sent/encoded first
(convEncode.h:50-66), and decoded bytes are filled MSb-first
(viterbiDecoderButterflyk1.c:245-249).

These helpers work on the trailing axis so they compose with vmap/batching.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def unpack_bits(data, bit_order: str = "big"):
    """Unpack uint8 bytes into 0/1 bits along the last axis.

    `big` order (the default) emits the MSb of each byte first, matching the
    reference encoder's consumption order (convEncode.c:73,91: the bit shifted
    in is ``workingBits >> (remainingBits-1)``).
    """
    data = jnp.asarray(data, dtype=jnp.uint8)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    if bit_order == "little":
        shifts = shifts[::-1]
    bits = (data[..., :, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits, bit_order: str = "big"):
    """Pack 0/1 bits (last axis, multiple of 8) into uint8 bytes."""
    bits = jnp.asarray(bits, dtype=jnp.uint8)
    if bits.shape[-1] % 8 != 0:
        raise ValueError(f"bit count {bits.shape[-1]} not a multiple of 8")
    grouped = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    if bit_order == "little":
        shifts = shifts[::-1]
    return jnp.sum(grouped << shifts, axis=-1).astype(jnp.uint8)


def unpack_bits_np(data: np.ndarray, bit_order: str = "big") -> np.ndarray:
    """NumPy twin of unpack_bits, for host-side oracles and tests."""
    data = np.asarray(data, dtype=np.uint8)
    bits = np.unpackbits(data, axis=-1, bitorder=bit_order[:3] if bit_order == "big" else "little")
    return bits


def pack_bits_np(bits: np.ndarray, bit_order: str = "big") -> np.ndarray:
    bits = np.asarray(bits, dtype=np.uint8)
    return np.packbits(bits, axis=-1, bitorder="big" if bit_order == "big" else "little")


def int_to_bits(value: int, width: int, newest_first: bool = False) -> np.ndarray:
    """Expand an integer into `width` bits.

    With newest_first=False the result is in *time order*: element 0 is the
    oldest bit (bit width-1 of the integer) and element width-1 is the newest
    (bit 0).  This matches the shift-into-LSb delay convention
    (convEncode.c:93): bit i of a state is the input from i shifts ago.
    """
    idx = np.arange(width) if newest_first else np.arange(width - 1, -1, -1)
    return ((value >> idx) & 1).astype(np.uint8)


def parity32(x):
    """Bitwise parity (popcount mod 2) of int32/uint32 arrays.

    XOR-fold replacement for the reference's __builtin_popcount(...) % 2
    (convEncode.c:140-149).
    """
    x = jnp.asarray(x)
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def parity32_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def popcount32(x):
    """Population count for int32/uint32 arrays (convEncode.c:140)."""
    x = jnp.asarray(x, dtype=jnp.uint32)
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)
