"""Batched CRC over GF(2) — the outer code of every production TBCC link.

Beyond-reference extension (the reference has no CRC; its BER harness
counts raw bit errors, berTestK7.c:163).  Real tail-biting receivers —
LTE PDCCH/PBCH, NR — attach a CRC to each transport block and use it
both for error *detection* and to pick the winner out of a Viterbi
candidate list (ops/tailbiting.py's CRC-aided list decode).

Batched formulation: an MSb-first non-reflected CRC is GF(2)-LINEAR
in the message bits, so a batch of CRCs is one bit-matrix multiply —

    remainder(m) = m @ M  (mod 2),   M[i] = x^(L-1-i+W) mod p(x)

— an int8 x int8 -> int32 matmul in XLA, then `& 1`.
A [B, L] batch costs one [B, L] x [L, W] matmul instead of B serial
L-step LFSR walks; the LFSR formulation survives only as the NumPy
oracle the tests check against.  Nonzero `init` adds an affine constant
(the LFSR is linear in (message, init) jointly), `xor_out` a final mask.

Bit conventions match the framework's MSb-first transport order
(convEncode.h:50-66): `bits[..., 0]` is transmitted first, and the
returned parity bits are MSb-first (out[..., 0] = coefficient of
x^(W-1)), the 3GPP transmission order.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class CrcSpec:
    """A cyclic redundancy check: x^width + (poly bits), MSb-first.

    Attributes:
      width: parity length W in bits.
      poly: generator polynomial WITHOUT the leading x^W term
        (e.g. CCITT CRC-16 = 0x1021).
      init: initial LFSR register value (3GPP CRCs use 0).
      xor_out: final XOR applied to the remainder before transmission.
    """
    width: int
    poly: int
    init: int = 0
    xor_out: int = 0

    def __post_init__(self):
        if not 1 <= self.width <= 32:
            raise ValueError(f"CRC width {self.width} out of range [1, 32]")
        mask = (1 << self.width) - 1
        for name in ("poly", "init", "xor_out"):
            v = getattr(self, name)
            if v & ~mask:
                raise ValueError(f"{name}=0x{v:x} exceeds width {self.width}")


# 3GPP polynomials (TS 36.212 / 38.212 §5.1) + the CCITT classic.
CRC24A = CrcSpec(24, 0x864CFB)        # LTE/NR transport-block CRC
CRC24B = CrcSpec(24, 0x800063)        # LTE/NR code-block CRC
CRC16_CCITT = CrcSpec(16, 0x1021)     # LTE gCRC16 (PDCCH payload, DL-SCH)
CRC11_NR = CrcSpec(11, 0x621)         # NR uplink control
CRC8_LTE = CrcSpec(8, 0x9B)           # LTE gCRC8 (CQI)
CRC6_NR = CrcSpec(6, 0x21)            # NR short UCI (x^6+x^5+1)


def crc_remainder_np(crc: CrcSpec, bits: np.ndarray) -> int:
    """NumPy/int LFSR oracle: remainder register after shifting `bits`
    (1-D array, MSb/transmit order first) through the MSb-first CRC
    LFSR.  The serial formulation every CRC reference implements; the
    batched matmul below is tested against it."""
    W, top = crc.width, 1 << (crc.width - 1)
    mask = (1 << W) - 1
    reg = crc.init
    for b in np.asarray(bits, np.uint8).reshape(-1):
        fb = ((reg >> (W - 1)) & 1) ^ int(b)
        reg = (reg << 1) & mask
        if fb:
            reg ^= crc.poly
    return reg ^ crc.xor_out


def _int_to_bits(v: int, width: int) -> np.ndarray:
    return np.array([(v >> (width - 1 - j)) & 1 for j in range(width)],
                    np.uint8)


@functools.lru_cache(maxsize=64)
def _crc_matrix(crc: CrcSpec, L: int) -> tuple[np.ndarray, np.ndarray]:
    """(M [L, W] int8, c [W] uint8): remainder(m) = (m @ M) & 1 ^ c.

    M[i] = x^(L-1-i+W) mod p(x), built back-to-front with one
    multiply-by-x reduction step per row; c folds in the affine `init`
    contribution (remainder of the all-zero length-L message) and
    `xor_out`."""
    W = crc.width
    mask = (1 << W) - 1
    M = np.empty((L, W), np.int8)
    r = crc.poly                       # x^W mod p
    for i in range(L - 1, -1, -1):
        M[i] = _int_to_bits(r, W)
        r <<= 1                        # multiply by x, reduce mod p
        if r >> W:
            r = (r & mask) ^ crc.poly
    zero_rem = 0
    if crc.init:
        # remainder(0^L, init): run the linear recurrence on the init
        # register alone — init * x^L mod p.
        zero_rem = crc.init
        for _ in range(L):
            fb = (zero_rem >> (W - 1)) & 1
            zero_rem = (zero_rem << 1) & mask
            if fb:
                zero_rem ^= crc.poly
    c = _int_to_bits(zero_rem ^ crc.xor_out, W)
    return M, c


def crc_bits(crc: CrcSpec, bits) -> jnp.ndarray:
    """Batched CRC parity: 0/1 uint8 [..., L] -> uint8 [..., W] parity
    bits in transmit (MSb-first) order.  One matmul per batch."""
    bits = jnp.asarray(bits)
    L = bits.shape[-1]
    M, c = _crc_matrix(crc, L)
    acc = jnp.matmul(bits.astype(jnp.int8), jnp.asarray(M),
                     preferred_element_type=jnp.int32)
    return ((acc & 1) ^ jnp.asarray(c, jnp.int32)).astype(jnp.uint8)


def crc_append(crc: CrcSpec, bits) -> jnp.ndarray:
    """[..., L] message bits -> [..., L + W] CRC-attached block (the
    3GPP attachment: parity appended MSb-first)."""
    return jnp.concatenate([jnp.asarray(bits, jnp.uint8),
                            crc_bits(crc, bits)], axis=-1)


def crc_check(crc: CrcSpec, block) -> jnp.ndarray:
    """[..., L + W] CRC-attached block -> bool [...]: parity consistent?"""
    block = jnp.asarray(block)
    msg, parity = block[..., :-crc.width], block[..., -crc.width:]
    want = crc_bits(crc, msg)
    return jnp.all(parity.astype(jnp.uint8) == want, axis=-1)
