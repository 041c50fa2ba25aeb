"""Convolutional encoder, vectorized.

Vectorized re-design of the reference encoder (src/convEncode.c).  The
reference encodes one bit per loop iteration through a shift register
(convEncode.c:59-98); here the whole packet is encoded at once: each coded
output stream j is the mod-2 convolution of the input bit-stream with
generator j, computed as an XOR-accumulation of strided slices — one slice
per set generator tap.  This is embarrassingly parallel over time and over
batch, so XLA maps it onto full vector registers with no sequential
dependence (SURVEY.md §3.1).

Semantics preserved exactly:
  * bits shift into the LSb of the tapped delay (convEncode.c:93);
  * generators are bit-reversed so LSb taps the newest bit (convEncode.c:15);
  * output segment packs generator j's bit at bit position j
    (convEncode.c:155-159);
  * termination appends S all-zero input steps and returns the register to
    state 0 (convEncode.c:101-122);
  * bytes are consumed MSb-first (convEncode.h:50-66).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec
from .bits import int_to_bits, unpack_bits


def _state_prefix_bits(spec: CodeSpec, state) -> jnp.ndarray:
    """Virtual input history implied by a starting state, in time order.

    Bit m of the delay register is the input from m shifts ago
    (convEncode.c:93), so the prefix (oldest first) is the state's bits from
    MSB down to LSB.
    """
    w = spec.k * spec.S
    idx = jnp.arange(w - 1, -1, -1)
    state = jnp.asarray(state, dtype=jnp.int32)
    return ((state[..., None] >> idx) & 1).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(0, 2))
def encode_bits(spec: CodeSpec, bits, terminate: bool = True,
                initial_state=None):
    """Encode a bit array into n-bit coded segments.

    Args:
      spec: the code.
      bits: 0/1 uint8 array [..., L]; L must be a multiple of k.  Bits are in
        transmission order (the reference's MSb-first byte order is handled
        by the byte-level wrappers).
      terminate: if True, append S all-zero steps to force the encoder back
        to state 0 (convEnc `last=true`, convEncode.c:101-119).
      initial_state: optional [...] int32 starting state (default
        spec.starting_state), for chunked/streaming use.

    Returns:
      (segments, final_state): segments is uint8 [..., T] with one n-bit
      segment per entry (T = L/k + S if terminated), exactly the layout of
      the reference's codedSegments array (convEncode.h:67).  final_state is
      int32 [...] — 0 after termination.
    """
    bits = jnp.asarray(bits, dtype=jnp.uint8)
    L = bits.shape[-1]
    if L % spec.k != 0:
        raise ValueError(f"bit count {L} not a multiple of k={spec.k}")
    kS = spec.k * spec.S
    if initial_state is None:
        initial_state = jnp.full(bits.shape[:-1], spec.starting_state,
                                 dtype=jnp.int32)
    prefix = _state_prefix_bits(spec, initial_state)
    parts = [prefix, bits]
    if terminate:
        parts.append(jnp.zeros(bits.shape[:-1] + (kS,), dtype=jnp.uint8))
    full = jnp.concatenate(parts, axis=-1)

    T = L // spec.k + (spec.S if terminate else 0)
    segment = jnp.zeros(bits.shape[:-1] + (T,), dtype=jnp.uint8)
    # For output step r, the newest bit sits at full[kS + (r+1)*k - 1]; tap m
    # of the reversed generator reads m positions earlier.  Each tap is a
    # stride-k slice of `full` — static shapes, no gathers.
    for j, grev in enumerate(spec.g_reversed):
        out_j = jnp.zeros(bits.shape[:-1] + (T,), dtype=jnp.uint8)
        for m in range(spec.delay_width):
            if (grev >> m) & 1:
                start = kS + spec.k - 1 - m
                tap = jax.lax.slice_in_dim(
                    full, start, start + (T - 1) * spec.k + 1, spec.k, axis=-1)
                out_j = out_j ^ tap
        segment = segment | (out_j << j)

    # Final state: low k*S bits of the delay register = the last k*S bits of
    # the (prefix + input [+ pad]) stream, newest at bit 0.
    tail = jax.lax.slice_in_dim(full, full.shape[-1] - kS, full.shape[-1],
                                1, axis=-1)
    weights = (1 << jnp.arange(kS - 1, -1, -1, dtype=jnp.int32))
    final_state = jnp.sum(tail.astype(jnp.int32) * weights, axis=-1)
    return segment, final_state


@functools.partial(jax.jit, static_argnums=(0, 2))
def encode_bytes(spec: CodeSpec, data, terminate: bool = True):
    """Encode uint8 bytes (MSb-first per byte, convEncode.h:66) into
    coded segments.  Returns uint8 [..., T] segments."""
    bits = unpack_bits(data)
    segments, _ = encode_bits(spec, bits, terminate)
    return segments


def encode_one_input(spec: CodeSpec, state: int, u: int) -> tuple[int, int]:
    """Single trellis step on host ints: shift k bits in (MSb first) and
    compute the coded segment.  Twin of convEncOneInput (convEncode.c:19-44),
    used to derive trellis tables (viterbiDecoder.c:41-48).

    Returns (segment, next_state)."""
    delay = ((state << spec.k) | u) & ((1 << spec.delay_width) - 1)
    seg = 0
    for j, grev in enumerate(spec.g_reversed):
        masked = delay & grev
        seg |= (bin(masked).count("1") & 1) << j
    next_state = delay & (spec.num_states - 1)
    return seg, next_state


def encode_bits_np(spec: CodeSpec, bits: np.ndarray, terminate: bool = True,
                   initial_state: int = 0) -> np.ndarray:
    """Scalar NumPy oracle encoder — an intentionally naive shift-register
    walk, used by tests as an independent check of the vectorized path."""
    bits = np.asarray(bits, dtype=np.uint8).ravel()
    if bits.size % spec.k != 0:
        raise ValueError("bit count not a multiple of k")
    if terminate:
        bits = np.concatenate([bits, np.zeros(spec.k * spec.S, np.uint8)])
    delay = int(initial_state)
    segs = []
    for r in range(bits.size // spec.k):
        for b in bits[r * spec.k:(r + 1) * spec.k]:
            delay = ((delay << 1) | int(b)) & ((1 << spec.delay_width) - 1)
        seg = 0
        for j, grev in enumerate(spec.g_reversed):
            seg |= (bin(delay & grev).count("1") & 1) << j
        segs.append(seg)
    return np.array(segs, dtype=np.uint8)
