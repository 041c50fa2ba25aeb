"""Traffic making: the convolutional encoder and the channels, on the device.

Copies of the program's encoder (`ops/encode.py`, k=1 codes), segment
corruption (`harness/speed.py` `_noisy_bufs`), BPSK over AWGN with exact
LLRs (`ops/channel.py`), puncturing (`ops/puncture.py`) and the LLR
quantizer (`ops/metrics.py` `quantize_llrs`), so that a change to the
program cannot change what it is fed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def key(seed: int, *path: int):
    """PRNG key of a seed of any size (more than 32 bits) and a path of
    small indices below it."""
    k = jax.random.PRNGKey(0)
    seed = int(seed)
    for word in (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, seed >> 64):
        k = jax.random.fold_in(k, word)
    for p in path:
        k = jax.random.fold_in(k, p)
    return k


def bit_reverse(value: int, width: int) -> int:
    out = 0
    for _ in range(width):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def encode(bits, K: int, gens):
    """Terminated rate-1/n encode: uint8 [..., L] bits -> uint8
    [..., L + K - 1] segments with generator j's bit at bit j.

    Bits shift into the low end of the delay register and generators are
    in Proakis order (MSb taps the newest bit), as in the reference
    encoder (convEncode.c:93, 163-175)."""
    S = K - 1
    bits = jnp.asarray(bits, jnp.uint8)
    T = bits.shape[-1] + S
    pad = jnp.zeros(bits.shape[:-1] + (S,), jnp.uint8)
    full = jnp.concatenate([pad, bits, pad], axis=-1)    # state 0 prefix
    seg = jnp.zeros(bits.shape[:-1] + (T,), jnp.uint8)
    for j, g in enumerate(gens):
        grev = bit_reverse(int(g), K)
        out = jnp.zeros_like(seg)
        for m in range(K):
            if (grev >> m) & 1:
                out = out ^ full[..., S - m:S - m + T]
        seg = seg | (out << j)
    return seg


def flip_segments(k, segments, n: int, p: float):
    """Each segment, with probability p, XORed with a uniform non-zero
    n-bit pattern."""
    k1, k2 = jax.random.split(k)
    hit = jax.random.uniform(k1, segments.shape) < p
    pattern = jax.random.randint(k2, segments.shape, 1, 1 << n, jnp.int32)
    return segments ^ (hit * pattern).astype(jnp.uint8)


def segments_to_bits(segments, n: int):
    """Coded bit-stream in transmission order, generator 0's bit first."""
    j = jnp.arange(n, dtype=jnp.uint8)
    bits = (segments[..., None] >> j) & 1
    return bits.reshape(*segments.shape[:-1], segments.shape[-1] * n)


def keep_positions(pattern, T: int) -> np.ndarray:
    """Indices of the transmitted bits of a T-step stream under a (n,
    period) puncture pattern (column p, row j: bit j of steps t = p mod
    period)."""
    pat = np.asarray(pattern, bool)
    reps = -(-T // pat.shape[1])
    return np.nonzero(np.tile(pat.T, (reps, 1)).reshape(-1)[: T * pat.shape[0]])[0]


def awgn_llrs(k, coded_bits, ebn0_db: float, rate: float):
    """BPSK (bit b -> 1 - 2b) over AWGN at Eb/N0 for a code of `rate`;
    exact LLRs 4 Es/N0 y (positive favours 0)."""
    esn0 = 10.0 ** (ebn0_db / 10.0) * rate
    sigma = np.sqrt(1.0 / (2.0 * esn0))
    y = 1.0 - 2.0 * coded_bits.astype(jnp.float32)
    y = y + jax.random.normal(k, y.shape) * sigma
    return 4.0 * esn0 * y


def quantize(llrs, qmax: int):
    """Signed integers in [-qmax, qmax], 3 sigma of the LLRs mapped onto
    qmax (the program's default gain control), stored as int8."""
    scale = jnp.maximum(3.0 * jnp.sqrt(jnp.mean(jnp.square(llrs))) / qmax,
                        1e-9)
    return jnp.clip(jnp.round(llrs / scale), -qmax, qmax).astype(jnp.int8)


def make_input(k, cfg: dict, rows: int, message_bits: int):
    """One buffer of received input for `rows` terminated packets of
    `message_bits` each, by the configuration's input form and channel:
    hard uint8 [rows, T] segments, or int8 [rows, kept] punctured LLRs."""
    K, gens = cfg["code"]["K"], tuple(cfg["code"]["generators"])
    n = len(gens)
    k_msg, k_ch = jax.random.split(k)
    msgs = jax.random.bernoulli(k_msg, 0.5, (rows, message_bits)).astype(
        jnp.uint8)
    seg = encode(msgs, K, gens)
    ch = cfg["channel"]
    if cfg["input"] == "hard":
        return flip_segments(k_ch, seg, n, ch["segment_flip_p"])
    if cfg["input"] == "soft_punctured":
        T = seg.shape[-1]
        kept = keep_positions(cfg["puncture"], T)
        coded = segments_to_bits(seg, n)[:, jnp.asarray(kept)]
        rate = message_bits / kept.size
        return quantize(awgn_llrs(k_ch, coded, ch["ebn0_db"], rate), ch["qmax"])
    raise ValueError(f"unknown input form {cfg['input']!r}")


def make_buffers(cfg: dict, rows: int, message_bits: int, seed: int,
                 count: int) -> tuple:
    """`count` distinct buffers of `make_input`, made on the device in one
    compiled call from the seed (the seed enters as keys, so every seed
    reuses one cached program)."""
    keys = jnp.stack([key(seed, j) for j in range(count)])
    make = jax.jit(lambda ks: tuple(
        jax.vmap(lambda k: make_input(k, cfg, rows, message_bits))(ks)[j]
        for j in range(count)))
    return jax.block_until_ready(make(keys))
