"""Chunked streaming encode/decode with explicit carried state.

The reference's codec is *streaming-stateful*: packets can be fed in
arbitrary chunks, with `convEncoderState_t` carrying partial-byte and
shift-register state between `convEnc` calls (convEncode.h:29-38,
convEncode.c:46-130) and the decoder carrying metrics/traceback state
across `viterbiDecoderHard` calls until `last=true`
(viterbiDecoder.h:128-145).  SURVEY.md §5 flags this seam as the
framework's checkpoint/resume analogue and the hook for time-block
sharding.

Here the carried state is an explicit, immutable pytree (functional JAX
style) wrapped in thin stateful conveniences.  The decoder is the
sliding-window register-exchange formulation (decode delay =
traceback_len), matching `viterbi_decode_stream` chunk-for-chunk.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec
from .encode import encode_bits
from .trellis import prev_state_table
from .viterbi import hard_step_metrics, init_metric_value


class DecoderState(NamedTuple):
    """Carried decoder state between chunks (viterbiDecoder.h:128-145's
    nodeMetrics/traceBack/iteration as an explicit value)."""
    metrics: jax.Array      # int32 [NS]
    registers: jax.Array    # uint8 [NS, W] survivor symbols, newest first
    count: jax.Array        # int32 — trellis steps consumed so far


def decoder_init(spec: CodeSpec, traceback_len: int = 0) -> DecoderState:
    W = traceback_len or spec.traceback_len
    NS = spec.num_states
    m = jnp.full((NS,), init_metric_value(spec), jnp.int32)
    m = m.at[spec.starting_state].set(0)
    return DecoderState(m, jnp.zeros((NS, W), jnp.uint8),
                        jnp.asarray(0, jnp.int32))


@functools.partial(jax.jit, static_argnums=(0, 3))
def decode_chunk(spec: CodeSpec, state: DecoderState, segments,
                 traceback_len: int = 0):
    """Consume a chunk of segments, emitting one symbol per step once the
    window is warm (viterbiDecoder.c:140-190 streaming emit).

    Returns (new_state, symbols uint8 [T'], valid bool [T']): symbols[t]
    is the decoded k-bit symbol for global step count+t-(W-1), valid where
    that index >= 0.
    """
    bm_all = hard_step_metrics(spec, segments)
    return _decode_chunk_from_bm(spec, state, bm_all, traceback_len)


@functools.partial(jax.jit, static_argnums=(0, 3))
def decode_chunk_soft(spec: CodeSpec, state: DecoderState, qllrs,
                      traceback_len: int = 0):
    """Soft-decision `decode_chunk`: quantized-LLR branch costs
    (ops/metrics.soft_step_metrics) with the same streaming emit and
    carried state.  `qllrs`: int [T', n]."""
    from .metrics import soft_step_metrics
    bm_all = soft_step_metrics(spec, qllrs)
    return _decode_chunk_from_bm(spec, state, bm_all, traceback_len)


def _decode_chunk_from_bm(spec: CodeSpec, state: DecoderState, bm_all,
                          traceback_len: int):
    W = traceback_len or spec.traceback_len
    NS = spec.num_states
    E = spec.num_edges_per_state
    prev = jnp.asarray(prev_state_table(spec))
    u_of_dst = jnp.arange(NS, dtype=jnp.int32) & (E - 1)
    bm_idx = u_of_dst[None, :] * NS + prev

    def step(carry, bm_t):
        m, reg = carry
        pm = m[prev] + bm_t.reshape(-1)[bm_idx]
        dec = jnp.argmin(pm, axis=0)
        new_m = jnp.min(pm, axis=0)
        src = prev[dec, jnp.arange(NS)]
        new_reg = jnp.concatenate(
            [u_of_dst[:, None].astype(jnp.uint8), reg[src, : W - 1]], axis=1)
        best = jnp.argmin(new_m)
        return (new_m, new_reg), new_reg[best, W - 1]

    (m, reg), symbols = jax.lax.scan(
        step, (state.metrics, state.registers), bm_all)
    T = symbols.shape[0]
    idx = state.count + jnp.arange(T, dtype=jnp.int32)
    valid = idx >= (W - 1)
    return DecoderState(m, reg, state.count + T), symbols, valid


@functools.partial(jax.jit, static_argnums=(0, 2))
def decode_flush(spec: CodeSpec, state: DecoderState,
                 traceback_len: int = 0):
    """Terminate the packet: flush the undecoded window from state 0's
    register, dropping the S pad steps (viterbiDecoder.c:194-231).

    Returns uint8 [W - 1 - S] symbols (oldest first).  When fewer than
    W - 1 steps were ever consumed, the LEADING (W - 1 - count) entries
    are register-init filler, not data — the stateful wrappers trim
    them (`max(0, W - 1 - count)`); raw callers must do the same."""
    W = traceback_len or spec.traceback_len
    return state.registers[0, spec.S:W - 1][::-1]


def _symbols_to_bits(spec: CodeSpec, symbols: np.ndarray) -> np.ndarray:
    bit_idx = np.arange(spec.k - 1, -1, -1)
    return ((symbols[:, None].astype(np.int32) >> bit_idx) & 1).astype(
        np.uint8).reshape(-1)


@dataclasses.dataclass
class StreamingEncoder:
    """Stateful chunked encoder (the convEnc seam, convEncode.c:46-130)."""
    spec: CodeSpec

    def __post_init__(self):
        self._state = jnp.asarray(self.spec.starting_state, jnp.int32)

    def encode(self, bits, last: bool = False) -> np.ndarray:
        segs, st = encode_bits(self.spec, jnp.asarray(bits, jnp.uint8),
                               terminate=last, initial_state=self._state)
        self._state = (jnp.asarray(self.spec.starting_state, jnp.int32)
                       if last else st)
        return np.asarray(segs)

    def reset(self):
        self._state = jnp.asarray(self.spec.starting_state, jnp.int32)


@dataclasses.dataclass
class StreamingDecoder:
    """Stateful chunked sliding-window decoder (decode delay =
    traceback_len), auto-resetting at `last` like the reference
    (viterbiDecoderButterflyk1.c:258).

    Caller contract (enforced): one packet per `last=True` cycle, and the
    chunk passed with `last=True` must END exactly at the packet's final
    (termination) segment — the flush drops the trailing S termination
    symbols from the undecoded window, which is only exact when those
    steps are the last ones consumed.  Feeding further segments after the
    termination without `last=True` would stream the termination symbols
    out as data; `decode` guards this by requiring every `last=True` call
    to consume at least one segment.

    With `soft=True`, chunks are quantized LLRs [T', n] instead of hard
    segments (ops/metrics.soft_step_metrics branch costs)."""
    spec: CodeSpec
    traceback_len: int = 0
    soft: bool = False

    def __post_init__(self):
        self.traceback_len = self.traceback_len or self.spec.traceback_len
        self._state = decoder_init(self.spec, self.traceback_len)
        self._bit_carry = np.zeros((0,), np.uint8)

    def decode(self, segments, last: bool = False) -> np.ndarray:
        """Feed a chunk; returns the newly decoded message bits."""
        if self.soft:
            segments = jnp.asarray(segments, jnp.int32)
        else:
            segments = jnp.asarray(segments, jnp.uint8)
        if last and segments.shape[0] == 0:
            raise ValueError(
                "StreamingDecoder: the last=True chunk must contain the "
                "packet's final segments (see class docstring); got an "
                "empty chunk, so the termination steps were already "
                "streamed and the flush accounting would be wrong.")
        chunk_fn = decode_chunk_soft if self.soft else decode_chunk
        self._state, symbols, valid = chunk_fn(
            self.spec, self._state, segments, self.traceback_len)
        out = np.asarray(symbols)[np.asarray(valid)]
        if last:
            # The termination symbols are the last S steps consumed, so
            # they sit inside the final W-1 window; decode_flush excludes
            # them and the streamed portion above never reaches them.
            # Short packets (count < W - 1): the window's oldest entries
            # are register-init filler, trimmed by consumed-step count so
            # exactly count - S message symbols come out in total.
            flush = np.asarray(decode_flush(self.spec, self._state,
                                            self.traceback_len))
            garbage = max(0, self.traceback_len - 1
                          - int(self._state.count))
            out = np.concatenate([out, flush[garbage:]])
            self.reset()
        return _symbols_to_bits(self.spec, out)

    def decode_bytes(self, segments, last: bool = False) -> np.ndarray:
        """Feed a chunk; returns newly completed decoded BYTES (MSb-first
        fill, viterbiDecoderButterflyk1.c:245-249).  Partial bytes carry
        across chunks — the decode-side twin of convEncoderState_t's
        remainingUncoded seam (convEncode.h:36-37), which is where the
        8 % k != 0 spillover lives.  At `last`, a trailing partial byte
        is flushed zero-padded."""
        from .bits import pack_bits_np
        bits = np.concatenate([self._bit_carry,
                               self.decode(segments, last)])
        if last:
            pad = (-bits.size) % 8
            bits = np.pad(bits, (0, pad))
            self._bit_carry = np.zeros((0,), np.uint8)
            return pack_bits_np(bits)
        n_full = bits.size // 8 * 8
        self._bit_carry = bits[n_full:]
        return pack_bits_np(bits[:n_full])

    def reset(self):
        self._state = decoder_init(self.spec, self.traceback_len)
        self._bit_carry = np.zeros((0,), np.uint8)


@dataclasses.dataclass
class StreamingDecoderBatch:
    """Batched stateful streaming decoder: B independent channels decoded
    with sliding-window emission (decode delay = traceback_len),
    bit-exact to per-channel `StreamingDecoder`/`viterbi_decode_stream`
    under any chunking (the vmapped register-exchange scan).

    Same caller contract as StreamingDecoder: one packet per last=True
    cycle, whose final chunk ends at the packet's last segment.

    With `soft=True`, chunks are quantized LLRs [B, T', n] instead of
    hard segments [B, T'].
    """
    spec: CodeSpec
    batch: int
    traceback_len: int = 0
    soft: bool = False

    def __post_init__(self):
        self.traceback_len = self.traceback_len or self.spec.traceback_len
        self.reset()

    def reset(self):
        W = self.traceback_len
        NS = self.spec.num_states
        m = jnp.full((NS,), init_metric_value(self.spec), jnp.int32)
        m = m.at[self.spec.starting_state].set(0)
        self._metrics = jnp.broadcast_to(m[None], (self.batch, NS))
        self._registers = jnp.zeros((self.batch, NS, W), jnp.uint8)
        self._count = 0
        self._bit_carry = np.zeros((self.batch, 0), np.uint8)

    def _decode_scan(self, segments):
        W = self.traceback_len
        chunk_fn = decode_chunk_soft if self.soft else decode_chunk
        count = jnp.full((self.batch,), self._count, jnp.int32)
        new_state, symbols, _ = jax.vmap(
            lambda m, r, c, s: chunk_fn(
                self.spec, DecoderState(m, r, c), s, W))(
            self._metrics, self._registers, count, segments)
        self._metrics = new_state.metrics
        self._registers = new_state.registers
        return symbols                               # (B, T) uint8

    def decode(self, segments, last: bool = False) -> np.ndarray:
        """Feed a chunk of [B, T'] segments; returns the newly decoded
        message bits [B, bits]."""
        if self.soft:
            segments = jnp.asarray(segments, jnp.int32)
            if segments.ndim != 3 or segments.shape[-1] != self.spec.n:
                raise ValueError(
                    f"soft chunks are [B, T', n={self.spec.n}] LLRs; got "
                    f"{segments.shape}")
        else:
            segments = jnp.asarray(segments, jnp.uint8)
        B, T = segments.shape[:2]
        if B != self.batch:
            raise ValueError(f"batch {B} != {self.batch}")
        if last and T == 0:
            raise ValueError(
                "the last=True chunk must contain the packet's final "
                "segments (see StreamingDecoder docstring)")
        if T == 0:
            # empty non-last chunk: nothing to decode (the scalar class
            # accepts this, so the batch class must too)
            return np.zeros((self.batch, 0), np.uint8)
        sym = np.asarray(self._decode_scan(segments))
        W = self.traceback_len
        idx = self._count + np.arange(T)
        self._count += T
        out = sym[:, idx >= (W - 1)]
        if last:
            # see StreamingDecoder.decode: trim register-init filler for
            # short packets (count < W - 1)
            flush = np.asarray(self._registers[:, 0, self.spec.S:W - 1])
            garbage = max(0, (W - 1) - self._count)
            out = np.concatenate([out, flush[:, ::-1][:, garbage:]],
                                 axis=1)
            self.reset()
        return _symbols_to_bits_batch(self.spec, out)

    def decode_bytes(self, segments, last: bool = False) -> np.ndarray:
        """Batched byte-granular streaming decode with partial-byte carry
        (see StreamingDecoder.decode_bytes).  Returns uint8 [B, bytes]."""
        from .bits import pack_bits_np
        bits = np.concatenate([self._bit_carry,
                               self.decode(segments, last)], axis=1)
        if last:
            pad = (-bits.shape[1]) % 8
            bits = np.pad(bits, ((0, 0), (0, pad)))
            self._bit_carry = np.zeros((self.batch, 0), np.uint8)
            return pack_bits_np(bits)
        n_full = bits.shape[1] // 8 * 8
        self._bit_carry = bits[:, n_full:]
        return pack_bits_np(bits[:, :n_full])


def _symbols_to_bits_batch(spec: CodeSpec, symbols: np.ndarray) -> np.ndarray:
    bit_idx = np.arange(spec.k - 1, -1, -1)
    bits = (symbols[:, :, None].astype(np.int32) >> bit_idx) & 1
    return bits.astype(np.uint8).reshape(symbols.shape[0], -1)


class BlockStreamingDecoderBatch:
    """Chunked decode with exact carried-metric continuity across calls,
    built on the block decoder's two operations (`kernels.core`): the
    reference's butterfly decoder needs the whole packet before
    `last=true` (viterbiDecoderButterflyk1.c:200-260), and its streaming
    decoder pays a per-step sliding-window emit.

    Feed [B, t] segment chunks (or [B, t, n] quantized LLRs with
    `soft=True`) of any sizes.  Every call runs the forward ACS over the
    new steps from the previous call's final metrics (an exact
    continuation, not a warm-up) and emits every decoded bit older than
    `lookahead` steps by a traceback from argmin(current metrics).  The
    `last=True` call walks from the terminal state 0 and emits the rest
    minus the S termination steps, so the concatenated emissions equal
    `kernels.viterbi_decode_batch` on the whole stream wherever survivor
    paths merge within `lookahead` (the truncation argument of
    viterbiDecoder.c:53-74).

    k=1 poly-symmetric codes only; other codes use
    `StreamingDecoderBatch`.
    """

    def __init__(self, spec: CodeSpec, batch: int,
                 lookahead: int | None = None, interpret: bool = False,
                 soft: bool = False):
        from ..kernels import core
        if not core.supported(spec):
            raise ValueError(
                "BlockStreamingDecoderBatch requires a k=1 poly-symmetric "
                "code; use StreamingDecoderBatch instead")
        la = spec.traceback_len if lookahead is None else int(lookahead)
        if la <= spec.S:
            # With no kept lookahead the termination steps would stream
            # out as message bits (the per-step path enforces W > S).
            raise ValueError(f"lookahead must exceed S={spec.S} "
                             f"(5K = {spec.traceback_len} is the "
                             f"standard choice); got {la}")
        self.spec = spec
        self.batch = batch
        self.interpret = interpret
        self.soft = soft
        self._keep = la
        self.reset()

    def reset(self):
        self._m = None           # carried final metrics [B, NS]
        self._pending = None     # decisions not yet emitted [t, Bp, NW]

    def _walk(self, start, n_steps: int, n_emit: int):
        from ..kernels import core
        B = self.batch
        by = core.traceback(self.spec, self._pending, start,
                            jnp.full((B,), n_steps, jnp.int32),
                            jnp.full((B,), n_emit, jnp.int32),
                            interpret=self.interpret)
        return core.bytes_to_bits(by, n_emit)

    def decode(self, segments, last: bool = False):
        """Consume a chunk, t >= 0; returns device-resident uint8 [B, e]
        decoded bits (e varies per call).  `last=True` flushes: total
        emissions then cover all (total segments - S) message positions,
        and the decoder resets for the next stream."""
        from ..kernels import core
        B = self.batch
        x = (core.as_int8_llrs(segments) if self.soft
             else jnp.asarray(segments, jnp.uint8))
        if x.shape[0] != B:
            raise ValueError(f"batch {x.shape[0]} != {B}")
        if x.shape[1]:
            dec, m = core.acs_forward(self.spec, x, self._m,
                                      interpret=self.interpret)
            # Only differences matter: keep carried metrics small.
            self._m = m - jnp.min(m, axis=1, keepdims=True)
            self._pending = (dec if self._pending is None else
                             jnp.concatenate([self._pending, dec]))
        held = 0 if self._pending is None else self._pending.shape[0]
        if last:
            n_final = max(held - self.spec.S, 0)
            bits = (self._walk(jnp.zeros((B,), jnp.int32), held, n_final)
                    if held else jnp.zeros((B, 0), jnp.uint8))
            self.reset()
            return bits
        n_emit = held - self._keep
        if n_emit <= 0:
            return jnp.zeros((B, 0), jnp.uint8)
        start = jnp.argmin(self._m, axis=1).astype(jnp.int32)
        bits = self._walk(start, held, n_emit)
        self._pending = self._pending[n_emit:]
        return bits
