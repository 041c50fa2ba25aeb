"""Tail-biting convolutional codes (beyond-reference extension).

The reference terminates every packet by flushing S all-zero steps
(convEncode.c:101-122), spending k*S trellis steps of pure overhead and
anchoring both ends of the survivor path at state 0.  Tail-biting —
the convention of LTE PBCH/PDCCH and IEEE 802.16 — removes that
overhead: the encoder *starts* in the state formed by the message's
last k*S bits, so it necessarily *ends* in the same state and the
trellis path is circular.  Rate is exactly k/n with no termination
loss, which matters for short packets.

Decoders here:

* `viterbi_decode_tailbiting` — the practical circular wrap decode:
  one Viterbi forward pass over the circularly extended sequence
  ``[last wl steps ++ packet ++ first wr steps]`` from uniform initial
  metrics, traceback from argmin(final metrics), keep the middle.
  This is the same truncation argument the reference writes out for
  finite traceback (viterbiDecoder.c:53-74) — survivor paths merge
  within ~5K steps — applied around the circle; it reuses the exact
  machinery of the time-block sharded decoder (parallel/sharding.py).
  Near-ML: it can disagree with the ML decoder only when survivors
  fail to merge within the wrap, i.e. at/beyond the code's correction
  limit.

* `viterbi_decode_tailbiting_exact` — the ML oracle: one constrained
  Viterbi per start state s (init 0 at s, forceNot elsewhere), scored
  by final_metrics[s], best circular path wins.  O(num_states) forward
  passes — a vmapped test reference, not a production path.

* `viterbi_decode_tailbiting_crc` (and its soft, punctured and
  rate-matched twins) — the batched CRC-aided list receiver: the plain
  wrap decode and the list candidates, the outer CRC picks the winner.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec
from .encode import encode_bits
from .metrics import soft_step_metrics
from .viterbi import (hard_step_metrics, traceback_terminated,
                      viterbi_forward, viterbi_forward_butterfly)


def tail_state(spec: CodeSpec, bits) -> jnp.ndarray:
    """Tail-biting initial (== final) state: the message's last k*S bits,
    newest at bit 0 (the delay-register convention, convEncode.c:93)."""
    kS = spec.k * spec.S
    tail = jnp.asarray(bits, jnp.int32)[..., -kS:]
    w = (1 << jnp.arange(kS - 1, -1, -1, dtype=jnp.int32))
    return jnp.sum(tail * w, axis=-1)


def default_wrap(spec: CodeSpec) -> int:
    """Default circular wrap length in trellis steps: comfortably past the
    ~5K survivor-merge rule (viterbiDecoder.c:53-74)."""
    return 6 * spec.K          # always > S = K - 1


@functools.partial(jax.jit, static_argnums=(0,))
def encode_tailbiting(spec: CodeSpec, bits):
    """Tail-biting encode: no termination flush; the initial state is the
    message tail, so the encoder's final state equals it (circular path).

    Args:
      bits: 0/1 uint8 [..., L]; L must be a multiple of k and >= k*S.
    Returns:
      uint8 [..., L/k] coded segments (rate exactly k/n).
    """
    bits = jnp.asarray(bits, jnp.uint8)
    L = bits.shape[-1]
    if L % spec.k:
        raise ValueError(f"bit count {L} not a multiple of k={spec.k}")
    if L < spec.k * spec.S:
        raise ValueError(
            f"tail-biting needs at least k*S={spec.k * spec.S} message bits "
            f"to define the wrap state; got {L}")
    seg, _ = encode_bits(spec, bits, terminate=False,
                         initial_state=tail_state(spec, bits))
    return seg


def _normalize_wrap(spec: CodeSpec, wrap) -> tuple[int, int]:
    if wrap is None:
        w = default_wrap(spec)
        return w, w
    if isinstance(wrap, int):
        return wrap, wrap
    wl, wr = wrap
    return int(wl), int(wr)


def circular_extend(x, wl: int, wr: int, axis: int = -1):
    """[..., T, ...] -> the circular extension with `wl` wrapped steps
    before and `wr` after (mod-indexing when a wrap exceeds T)."""
    T = x.shape[axis]
    if 0 <= wl <= T and 0 <= wr <= T:
        left = jax.lax.slice_in_dim(x, T - wl, T, axis=axis)
        right = jax.lax.slice_in_dim(x, 0, wr, axis=axis)
        return jnp.concatenate([left, x, right], axis=axis)
    idx = np.arange(-wl, T + wr) % T
    return jnp.take(x, jnp.asarray(idx), axis=axis)


@functools.partial(jax.jit, static_argnums=(0, 2))
def viterbi_decode_tailbiting(spec: CodeSpec, segments, wrap=None):
    """Circular wrap decode of one tail-biting packet (hard decision).

    Args:
      segments: uint8 [T] hard n-bit segments (T = L/k — no termination).
      wrap: wrap length in trellis steps — an int (both sides) or an
        (wl, wr) tuple; default `default_wrap(spec)`.
    Returns:
      uint8 [T * k] decoded message bits.
    """
    segments = jnp.asarray(segments, jnp.uint8)
    T = segments.shape[-1]
    wl, wr = _normalize_wrap(spec, wrap)
    ext = circular_extend(segments, wl, wr)
    uniform = jnp.zeros((spec.num_states,), jnp.int32)
    if spec.k == 1 and spec.has_poly_symmetry:
        decisions, fm = viterbi_forward_butterfly(spec, ext,
                                                  initial_metrics=uniform)
    else:
        bm = hard_step_metrics(spec, ext)
        decisions, fm = viterbi_forward(spec, bm, initial_metrics=uniform)
    start = jnp.argmin(fm).astype(jnp.int32)     # ties -> lowest state
    bits = traceback_terminated(spec, decisions, num_pad=0,
                                start_state=start)
    return jax.lax.slice_in_dim(bits, wl * spec.k, (wl + T) * spec.k)


@functools.partial(jax.jit, static_argnums=(0, 2))
def viterbi_decode_tailbiting_soft(spec: CodeSpec, qllrs, wrap=None):
    """Circular wrap decode from quantized LLRs (ops/metrics.py).

    Args:
      qllrs: int [T, n] quantized LLRs (zero = erasure, so depunctured
        streams ride through unchanged).
    Returns:
      uint8 [T * k] decoded message bits.
    """
    qllrs = jnp.asarray(qllrs, jnp.int32)
    T = qllrs.shape[-2]
    wl, wr = _normalize_wrap(spec, wrap)
    ext = circular_extend(qllrs, wl, wr, axis=-2)
    bm = soft_step_metrics(spec, ext)
    uniform = jnp.zeros((spec.num_states,), jnp.int32)
    decisions, fm = viterbi_forward(spec, bm, initial_metrics=uniform)
    start = jnp.argmin(fm).astype(jnp.int32)
    bits = traceback_terminated(spec, decisions, num_pad=0,
                                start_state=start)
    return jax.lax.slice_in_dim(bits, wl * spec.k, (wl + T) * spec.k)


def _list_from_forward(spec: CodeSpec, decisions, fm, list_size: int,
                       wl: int, T: int):
    """Shared list epilogue: the `list_size` best end states by
    (metric, state) lexicographic order — the same tie convention as
    argmin (ties -> lowest state) — each traced back independently.

    List decodes use a LEFT-only circular extension: with observations
    continuing past the message end, tracebacks from different end
    states would merge inside the right wrap and every candidate would
    decode an identical message window (measured: zero list diversity).
    Ending the trellis at the message end keeps the candidates distinct
    over the last ~5K message bits — exactly the region an outer CRC
    adjudicates.
    Returns (bits [list_size, T*k], metrics [list_size])."""
    NS = spec.num_states
    key = fm * NS + jnp.arange(NS, dtype=fm.dtype)
    order = jnp.sort(key)[:list_size]
    states = (order % NS).astype(jnp.int32)

    def one(s):
        bits = traceback_terminated(spec, decisions, num_pad=0,
                                    start_state=s)
        return jax.lax.slice_in_dim(bits, wl * spec.k, (wl + T) * spec.k)

    cand = jax.vmap(one)(states)
    return cand, fm[states]


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def viterbi_decode_tailbiting_list(spec: CodeSpec, segments,
                                   list_size: int = 4, wrap=None):
    """List wrap decode (hard decision): the `list_size` best candidate
    circular paths of one tail-biting packet, one per trellis end-state
    in (final metric, state) order.  Candidate 0 is the argmin decode;
    an outer CRC picks the winner (see `ops.crc` and the batched
    receiver `viterbi_decode_tailbiting_crc`).

    Args:
      wrap: LEFT wrap (warm-up) length in trellis steps (int; default
        `default_wrap`).  The trellis deliberately ends at the message
        end — a right wrap would merge all candidates (see
        `_list_from_forward`).
    Returns:
      (uint8 [list_size, T*k] candidate message bits,
       int32 [list_size] candidate final metrics, ascending).
    """
    if not 1 <= list_size <= spec.num_states:
        raise ValueError(f"list_size {list_size} must be in "
                         f"[1, num_states={spec.num_states}] — there is "
                         f"one candidate per trellis end state")
    segments = jnp.asarray(segments, jnp.uint8)
    T = segments.shape[-1]
    wl = default_wrap(spec) if wrap is None else int(wrap)
    ext = circular_extend(segments, wl, 0)
    uniform = jnp.zeros((spec.num_states,), jnp.int32)
    if spec.k == 1 and spec.has_poly_symmetry:
        decisions, fm = viterbi_forward_butterfly(spec, ext,
                                                  initial_metrics=uniform)
    else:
        bm = hard_step_metrics(spec, ext)
        decisions, fm = viterbi_forward(spec, bm, initial_metrics=uniform)
    return _list_from_forward(spec, decisions, fm, list_size, wl, T)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def viterbi_decode_tailbiting_list_soft(spec: CodeSpec, qllrs,
                                        list_size: int = 4, wrap=None):
    """Soft-decision twin of `viterbi_decode_tailbiting_list` (quantized
    LLRs in, `list_size` candidates out; `wrap` is the LEFT wrap)."""
    if not 1 <= list_size <= spec.num_states:
        raise ValueError(f"list_size {list_size} must be in "
                         f"[1, num_states={spec.num_states}]")
    qllrs = jnp.asarray(qllrs, jnp.int32)
    T = qllrs.shape[-2]
    wl = default_wrap(spec) if wrap is None else int(wrap)
    ext = circular_extend(qllrs, wl, 0, axis=-2)
    bm = soft_step_metrics(spec, ext)
    uniform = jnp.zeros((spec.num_states,), jnp.int32)
    decisions, fm = viterbi_forward(spec, bm, initial_metrics=uniform)
    return _list_from_forward(spec, decisions, fm, list_size, wl, T)


@functools.partial(jax.jit, static_argnums=(0,))
def viterbi_decode_tailbiting_exact(spec: CodeSpec, segments):
    """ML tail-biting decode (test oracle): the best circular path over
    all num_states constrained (start == end) Viterbi passes."""
    segments = jnp.asarray(segments, jnp.uint8)
    T = segments.shape[-1]
    if T * spec.n >= (1 << 20):
        # the exclusion constant must dominate any real path metric, or
        # an unconstrained big-seeded path could undercut a true
        # circular one and the "exact ML" guarantee silently breaks
        raise ValueError(
            f"packet too long for the exact oracle: T*n = {T * spec.n} "
            f">= 2^20 exclusion scale (use the wrap decoder)")
    bm = hard_step_metrics(spec, segments)
    NS = spec.num_states
    big = jnp.int32(1) << 20        # > any real path metric (n per step)

    def one(s):
        init = jnp.full((NS,), big, jnp.int32).at[s].set(0)
        dec, fm = viterbi_forward(spec, bm, initial_metrics=init)
        return dec, fm[s]

    decs, scores = jax.vmap(one)(jnp.arange(NS, dtype=jnp.int32))
    best = jnp.argmin(scores).astype(jnp.int32)   # ties -> lowest state
    return traceback_terminated(spec, decs[best], num_pad=0,
                                start_state=best)


def _crc_select(crc, plain, cands):
    """CRC winner selection over {the two-sided plain wrap decode} ++
    {the metric-ordered list candidates}: the plain decode wins when it
    passes (it sees the right-wrap context the list trellis gives up
    for candidate diversity); otherwise the best passing candidate;
    when nothing passes, the plain decode — so the output is never
    worse than the plain wrap decode alone.

    Returns (bits [B, T], ok [B] bool, chosen [B] int32: 0 = the plain
    decode (also the no-pass fallback), l >= 1 = list candidate l-1)."""
    from .crc import crc_check
    allb = jnp.concatenate([plain[:, None], cands], axis=1)
    ok = crc_check(crc, allb)                    # [B, 1 + Lc]
    any_ok = jnp.any(ok, axis=1)
    chosen = jnp.argmax(ok, axis=1).astype(jnp.int32)
    chosen = jnp.where(any_ok, chosen, 0)
    out = jnp.take_along_axis(allb, chosen[:, None, None], axis=1)[:, 0]
    return out, any_ok, chosen


@functools.partial(jax.jit, static_argnums=(0, 1, 3, 4))
def viterbi_decode_tailbiting_crc(spec: CodeSpec, crc, segments,
                                  list_size: int = 4, wrap=None):
    """Batched CRC-aided list decode of tail-biting packets (hard
    decision) — the TBCC receive chain of LTE PDCCH/PBCH style: the
    `list_size` best end-state paths plus the plain two-sided wrap
    decode, the outer CRC (`ops.crc.CrcSpec`) picks the winner.  The
    block-error rate is never worse than the plain wrap decode's;
    `ok=False` channels fall back to the plain decode and should be
    treated as erasures by the caller.

    Args:
      crc: `CrcSpec` of the outer code; each packet's message bits must
        be `crc_append`-formatted (payload ++ parity).
      segments: uint8 [B, T] hard n-bit segments.
      wrap: wrap length (int) — both sides for the plain decode, the
        left warm-up for the list.
    Returns:
      (uint8 [B, T*k] decoded bits (payload ++ parity), bool [B] CRC
       pass flag, int32 [B] chosen index: 0 = plain decode, l >= 1 =
       candidate l-1).
    """
    plain = jax.vmap(lambda s: viterbi_decode_tailbiting(spec, s, wrap))(
        segments)
    cands, _ = jax.vmap(lambda s: viterbi_decode_tailbiting_list(
        spec, s, list_size, wrap))(segments)
    return _crc_select(crc, plain, cands)


@functools.partial(jax.jit, static_argnums=(0, 1, 3, 4))
def viterbi_decode_tailbiting_crc_soft(spec: CodeSpec, crc, qllrs,
                                       list_size: int = 4, wrap=None):
    """Soft-decision twin of `viterbi_decode_tailbiting_crc` (quantized
    demodulator LLRs [B, T, n] in)."""
    plain = jax.vmap(lambda q: viterbi_decode_tailbiting_soft(
        spec, q, wrap))(qllrs)
    cands, _ = jax.vmap(lambda q: viterbi_decode_tailbiting_list_soft(
        spec, q, list_size, wrap))(qllrs)
    return _crc_select(crc, plain, cands)


@functools.partial(jax.jit, static_argnums=(0, 1, 3, 4, 5, 6))
def viterbi_decode_tailbiting_punctured_crc(spec: CodeSpec, crc, rx_qllrs,
                                            pattern, T: int,
                                            list_size: int = 8, wrap=None):
    """The LTE control-channel receive chain in one jit: depuncture
    (zero-LLR erasures) -> soft wrap list Viterbi -> CRC selection.

    Args:
      rx_qllrs: int [B, kept] quantized LLRs of the TRANSMITTED bits, in
        transmission order (step-major, generator j within step).
      pattern: puncture pattern tuple (e.g. ops.puncture.PUNCTURE_3_4).
      T: trellis steps (= message bits for k=1) per packet.
    Returns: as `viterbi_decode_tailbiting_crc`.
    """
    from .puncture import depuncture_llrs
    q = depuncture_llrs(jnp.asarray(rx_qllrs, jnp.int32), pattern, T)
    return viterbi_decode_tailbiting_crc_soft(
        spec, crc, q.reshape(q.shape[0], T, spec.n), list_size, wrap)


@functools.partial(jax.jit, static_argnums=(0, 1, 3, 4, 5, 6))
def viterbi_decode_tailbiting_ratematched_crc(spec: CodeSpec, crc, rx_qllrs,
                                              D: int, list_size: int = 8,
                                              wrap=None,
                                              qmax: int | None = None):
    """The standard-conformant LTE receive chain in one jit: 36.212
    §5.1.4.2 de-rate-matching (sub-block deinterleave + circular-buffer
    scatter-add: repetition soft combining, puncture erasures) -> soft
    wrap list Viterbi -> CRC selection.  E = rx_qllrs.shape[-1] may be
    anything: E < 3D punctures, E > 3D repeats.

    Args:
      rx_qllrs: int [B, E] quantized LLRs in transmission order.
      D: trellis steps (= payload+CRC bits for k=1) per block.
      qmax: clip of the combined LLRs (default
        `ops.metrics.DEFAULT_QMAX`).
    Returns: as `viterbi_decode_tailbiting_crc` ([B, D] bits).
    """
    from .metrics import DEFAULT_QMAX
    from .ratematch import derate_match
    q = derate_match(jnp.asarray(rx_qllrs), spec, D,
                     qmax=DEFAULT_QMAX if qmax is None else qmax)
    return viterbi_decode_tailbiting_crc_soft(spec, crc, q, list_size, wrap)
