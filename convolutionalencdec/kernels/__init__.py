"""Batched block-decode entry points.

k=1 butterfly codes decode on the Hopper core (`kernels.core`, Pallas on
the Triton route) when JAX runs on the GPU; every other code, and every
other platform, decodes with the plain `lax.scan` decoders of `ops/`.
`core.use_kernel` is the one place that chooses.  `interpret=True` runs
the core in the Pallas interpreter, for tests on the CPU.

All entries are bit-identical to `jax.vmap` of the scan decoders.  Soft
inputs are quantized LLRs saturated to the int8 range.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..params import CodeSpec
from . import core
from .core import use_kernel


def _on_core(spec: CodeSpec, interpret: bool) -> bool:
    return core.supported(spec) and (interpret or core.use_kernel(spec))


def _pack(bits):
    from ..ops.bits import pack_bits
    pad = (-bits.shape[-1]) % 8
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    return pack_bits(bits)


def _scan_bits(spec: CodeSpec, x, soft: bool):
    from ..ops.metrics import viterbi_decode_soft
    from ..ops.viterbi import viterbi_decode
    if soft:
        return jax.vmap(lambda q: viterbi_decode_soft(
            spec, q.astype(jnp.int32)))(x)
    return jax.vmap(lambda c: viterbi_decode(spec, c))(x)


def _block_bytes(spec: CodeSpec, x, L: int, soft: bool, interpret: bool):
    if _on_core(spec, interpret):
        B = x.shape[0]
        by = core.decode_bytes(spec, x, emit_end=jnp.full((B,), L, jnp.int32),
                               interpret=interpret)
        return by[:, : -(-L // 8)]
    return _pack(_scan_bits(spec, x, soft)[:, :L])


def _block_bits(spec: CodeSpec, x, L: int, soft: bool, interpret: bool):
    if _on_core(spec, interpret):
        return core.bytes_to_bits(_block_bytes(spec, x, L, soft, interpret), L)
    return _scan_bits(spec, x, soft)[:, :L]


def _message_bits(spec: CodeSpec, T: int, message_bits):
    return (T - spec.S) * spec.k if message_bits is None else message_bits


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def viterbi_decode_batch(spec: CodeSpec, segments,
                         message_bits: int | None = None,
                         interpret: bool = False):
    """Hard-decision block decode of a batch of terminated packets.

    Args:
      segments: uint8 [B, T] hard segments, T = L/k + S.
      message_bits: decoded bit count L; defaults to (T - S) * k.
    Returns:
      uint8 [B, L] decoded message bits.
    """
    segments = jnp.asarray(segments, jnp.uint8)
    L = _message_bits(spec, segments.shape[1], message_bits)
    return _block_bits(spec, segments, L, False, interpret)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def viterbi_decode_batch_bytes(spec: CodeSpec, segments,
                               message_bits: int | None = None,
                               interpret: bool = False):
    """Byte twin of `viterbi_decode_batch` (MSb-first fill, zero-padded
    trailing byte, viterbiDecoder.c:152-189).  Returns uint8
    [B, ceil(L/8)]."""
    segments = jnp.asarray(segments, jnp.uint8)
    L = _message_bits(spec, segments.shape[1], message_bits)
    return _block_bytes(spec, segments, L, False, interpret)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def viterbi_decode_batch_soft(spec: CodeSpec, qllrs,
                              message_bits: int | None = None,
                              interpret: bool = False):
    """Soft-decision block decode of a batch of terminated packets.

    Args:
      qllrs: int [B, T, n] quantized LLRs (ops/metrics.quantize_llrs).
    Returns:
      uint8 [B, L] decoded message bits (L = (T - S) * k by default).
    """
    qllrs = core.as_int8_llrs(qllrs)
    L = _message_bits(spec, qllrs.shape[1], message_bits)
    return _block_bits(spec, qllrs, L, True, interpret)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def viterbi_decode_batch_soft_bytes(spec: CodeSpec, qllrs,
                                    message_bits: int | None = None,
                                    interpret: bool = False):
    """Byte twin of `viterbi_decode_batch_soft`.  Returns uint8
    [B, ceil(L/8)]."""
    qllrs = core.as_int8_llrs(qllrs)
    L = _message_bits(spec, qllrs.shape[1], message_bits)
    return _block_bytes(spec, qllrs, L, True, interpret)


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4, 5))
def viterbi_decode_batch_punctured(spec: CodeSpec, rx_bits, pattern,
                                   T: int, message_bits: int | None = None,
                                   interpret: bool = False):
    """Batched decode of HARD punctured streams: received bits become ±1
    pseudo-LLRs and punctured positions zero-LLR erasures
    (ops/puncture.py), decoded by the soft path.

    Args:
      rx_bits: uint8 [B, kept] received coded bits in transmission order
        (puncture_bits' output order).
      pattern: static (n, period) 0/1 puncture pattern (tuples).
      T: mother-code trellis steps.
    Returns:
      uint8 [B, L] decoded message bits.
    """
    from ..ops.metrics import hard_bits_to_qllrs
    from ..ops.puncture import check_pattern_rows, depuncture_llrs
    check_pattern_rows(spec, pattern)
    q = depuncture_llrs(hard_bits_to_qllrs(jnp.asarray(rx_bits)), pattern, T)
    return viterbi_decode_batch_soft(spec, q.reshape(-1, T, spec.n),
                                     message_bits, interpret)


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4, 5))
def viterbi_decode_batch_punctured_soft(spec: CodeSpec, qllrs, pattern,
                                        T: int,
                                        message_bits: int | None = None,
                                        interpret: bool = False):
    """Batched SOFT decode of punctured streams.

    Args:
      qllrs: int [B, kept] quantized LLRs of the TRANSMITTED bits, in
        transmission order; punctured positions are re-inserted as
        zero-LLR erasures.
      pattern, T: as `viterbi_decode_batch_punctured`.
    Returns:
      uint8 [B, L] decoded message bits.
    """
    from ..ops.puncture import check_pattern_rows, depuncture_llrs
    check_pattern_rows(spec, pattern)
    q = depuncture_llrs(core.as_int8_llrs(qllrs), pattern, T)
    return viterbi_decode_batch_soft(spec, q.reshape(-1, T, spec.n),
                                     message_bits, interpret)


def _ragged_bytes(spec: CodeSpec, x, lens, soft: bool, interpret: bool):
    L = (x.shape[1] - spec.S) * spec.k
    if _on_core(spec, interpret):
        by = core.decode_bytes(spec, x, end=lens, interpret=interpret)
        return by[:, : -(-L // 8)]
    return _pack(_ragged_scan(spec, x, lens, soft))


def _ragged_scan(spec: CodeSpec, x, lens, soft: bool):
    from ..ops.metrics import viterbi_decode_ragged_soft
    from ..ops.viterbi import viterbi_decode_ragged
    fn = viterbi_decode_ragged_soft if soft else viterbi_decode_ragged
    return fn(spec, x, lens)


@functools.partial(jax.jit, static_argnums=(0, 3))
def viterbi_decode_batch_ragged(spec: CodeSpec, segments, seg_lengths,
                                interpret: bool = False):
    """Ragged-batch hard decode: per-channel packet lengths in one call.

    The walk of channel b starts in state 0 after its last step
    t_b - 1, so a mixed batch decodes in one call (the reference decodes
    one packet per call, viterbiDecoderButterflyk1.c:82-260).

    Args:
      segments: uint8 [B, Tmax]; rows padded arbitrarily beyond t_b.
      seg_lengths: int32 [B] (traced ok) valid segment counts,
        t_b = l_b / k + S.
    Returns:
      uint8 [B, (Tmax - S) * k]; positions >= (t_b - S) * k are zero.
    """
    segments = jnp.asarray(segments, jnp.uint8)
    lens = jnp.asarray(seg_lengths, jnp.int32)
    if _on_core(spec, interpret):
        by = _ragged_bytes(spec, segments, lens, False, interpret)
        return core.bytes_to_bits(by, (segments.shape[1] - spec.S) * spec.k)
    return _ragged_scan(spec, segments, lens, False)


@functools.partial(jax.jit, static_argnums=(0, 3))
def viterbi_decode_batch_bytes_ragged(spec: CodeSpec, segments,
                                      seg_lengths, interpret: bool = False):
    """Ragged-batch hard decode to packed bytes (MSb-first fill,
    per-channel zero padding, viterbiDecoder.c:152-189).  Returns uint8
    [B, ceil((Tmax - S) * k / 8)]."""
    return _ragged_bytes(spec, jnp.asarray(segments, jnp.uint8),
                         jnp.asarray(seg_lengths, jnp.int32), False,
                         interpret)


@functools.partial(jax.jit, static_argnums=(0, 3))
def viterbi_decode_batch_soft_bytes_ragged(spec: CodeSpec, qllrs,
                                           seg_lengths,
                                           interpret: bool = False):
    """Soft-decision twin of `viterbi_decode_batch_bytes_ragged` over
    quantized LLRs.  Returns uint8 [B, ceil((Tmax - S) * k / 8)]."""
    return _ragged_bytes(spec, core.as_int8_llrs(qllrs),
                         jnp.asarray(seg_lengths, jnp.int32), True,
                         interpret)


__all__ = [
    "core",
    "use_kernel",
    "viterbi_decode_batch",
    "viterbi_decode_batch_bytes",
    "viterbi_decode_batch_soft",
    "viterbi_decode_batch_soft_bytes",
    "viterbi_decode_batch_punctured",
    "viterbi_decode_batch_punctured_soft",
    "viterbi_decode_batch_ragged",
    "viterbi_decode_batch_bytes_ragged",
    "viterbi_decode_batch_soft_bytes_ragged",
]
