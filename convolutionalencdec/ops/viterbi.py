"""Viterbi decoders (reference semantics, jax.lax.scan formulation).

These are the framework's *semantic ground truth* decoders — bit-exact twins
of the reference's two decoders, re-expressed as functional scans:

  * `viterbi_forward` / `traceback_terminated`: the generic any-k decoder's
    ACS recurrence (viterbiDecoder.c:52-131) combined with the butterfly
    decoder's deferred block traceback from state 0
    (viterbiDecoderButterflyk1.c:200-260).
  * `viterbi_forward_butterfly`: the k=1 poly-symmetry butterfly formulation
    (viterbiDecoderButterflyk1.c:82-196) — one edge metric per butterfly,
    complement for the rest, branchless compare/select.  Produces decisions
    bit-identical to `viterbi_forward`, and the reference of the
    decoder core in kernels/core.py.
  * `viterbi_decode_stream`: the generic decoder's streaming sliding-window
    traceback (decode delay = traceback_len) via register exchange
    (viterbiDecoder.c:122-125,140-190).

Metric conventions match the reference exactly so the hand-traced white-box
asserts (handTracedTest/handTraced.c:72-115) reproduce: initial metrics are 0
for state 0 and `num_states + 1` for the rest (resetViterbiDecoderHard,
viterbiDecoder.c:243-253), and ties select the lowest decision index
(argmin2 uses <=, viterbiDecoder.c:425-430; butterfly uses a[0] > a[1],
viterbiDecoderButterflyk1.c:129).

All decoders use int32 metrics without renormalization (exact), as does
the decoder core; the reference's uint8 renormalized metrics
(viterbiDecoder.h:47-51, viterbiDecoderButterflyk1.c:159-183) never
change decisions because only metric differences matter.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec
from .trellis import butterfly_coded_bits, edge_coded_bits, prev_state_table


def init_metric_value(spec: CodeSpec) -> int:
    """Initial path metric for states other than starting_state.

    The reference seeds them with NUM_STATES + 1 ("forceNot",
    viterbiDecoder.c:246-249); for large state counts the value is clamped
    (any value comfortably above the worst real warm-up metric n*S is
    equivalent — only differences matter, and a forceNot state only needs
    to lose every compare until it is first reached, within S steps).
    Scan decoders and the decoder core share this value so their
    decisions stay bit-identical.
    """
    return min(spec.num_states + 1, max(64, spec.n * spec.S + 2))


def hard_step_metrics(spec: CodeSpec, segments) -> jnp.ndarray:
    """Per-step branch metrics from hard-decision n-bit segments.

    Returns int32 [..., T, 2^k, num_states]: entry [t, u, s] is the Hamming
    distance between received segment t and the coded bits of edge
    (src=s, input=u) — the reference's edgeMetrics lookup composed with the
    edgeCodedBits table (viterbiDecoder.c:86-90,107-109).
    """
    ec = edge_coded_bits(spec)  # [2^k, NS] uint8
    # Hamming distance table D[c, u, s] for every possible received segment c.
    c = np.arange(1 << spec.n, dtype=np.uint8)[:, None, None]
    x = np.bitwise_xor(c, ec[None])
    table = np.zeros(x.shape, dtype=np.int32)
    for j in range(spec.n):
        table += (x >> j) & 1
    segments = jnp.asarray(segments, dtype=jnp.int32)
    return jnp.asarray(table)[segments]


@functools.partial(jax.jit, static_argnums=(0, 2))
def viterbi_forward(spec: CodeSpec, step_metrics, collect_metrics: bool = False,
                    initial_metrics=None):
    """Run the ACS (add-compare-select) recurrence over the trellis.

    Args:
      spec: the code.
      step_metrics: [T, 2^k, num_states] additive branch metrics; entry
        [t, u, s] is the cost of leaving state s on the input-u edge at step
        t.  Hard decision -> Hamming distances (`hard_step_metrics`); soft
        decision -> quantized LLR costs (ops/metrics.py).
      collect_metrics: also return the [T, num_states] path-metric history
        (for white-box tests mirroring handTraced.c:72-115).
      initial_metrics: optional int32 [num_states] starting path metrics.
        Default is the reference's known-start seeding (0 at starting_state,
        forceNot elsewhere, viterbiDecoder.c:246-249); a uniform vector
        (zeros) gives the truncation-decode start used by time-block
        sharding and tail-biting wrap decoding.

    Returns:
      (decisions, final_metrics[, metric_history]) where decisions is uint8
      [T, num_states]: decisions[t, d] = the argmin decision index e (the k
      shifted-out bits of the chosen source, viterbiDecoder.c:104-116).
    """
    NS = spec.num_states
    E = spec.num_edges_per_state
    prev = jnp.asarray(prev_state_table(spec))          # [E, NS]
    u_of_dst = jnp.arange(NS, dtype=jnp.int32) & (E - 1)
    # Flat index into step_metrics[t] for (u_of_dst[d], prev[e, d]).
    bm_idx = u_of_dst[None, :] * NS + prev               # [E, NS]

    if initial_metrics is None:
        init = jnp.full((NS,), init_metric_value(spec), dtype=jnp.int32)
        init = init.at[spec.starting_state].set(0)
    else:
        init = jnp.asarray(initial_metrics, jnp.int32)

    def step(m, bm_t):
        pm = m[prev] + bm_t.reshape(-1)[bm_idx]          # [E, NS]
        dec = jnp.argmin(pm, axis=0).astype(jnp.uint8)   # first min == lowest e
        new_m = jnp.min(pm, axis=0)
        ys = (dec, new_m) if collect_metrics else dec
        return new_m, ys

    final_m, ys = jax.lax.scan(step, init, jnp.asarray(step_metrics, jnp.int32))
    if collect_metrics:
        decisions, history = ys
        return decisions, final_m, history
    return ys, final_m


@functools.partial(jax.jit, static_argnums=(0,))
def viterbi_forward_butterfly(spec: CodeSpec, segments, initial_metrics=None):
    """k=1 butterfly ACS with the poly-symmetry single-edge-metric trick.

    Butterfly b has sources {b, b + NS/2} and destinations {2b, 2b+1}
    (viterbiDecoderButterflyk1.c:101-152).  With every generator tapping both
    the newest and oldest bit, the four edge metrics are one Hamming distance
    m and its complement n - m (viterbiDecoder.h:33-39):

        dst 2b   (u=0):  src b costs m,      src b+NS/2 costs n-m
        dst 2b+1 (u=1):  src b costs n-m,    src b+NS/2 costs m

    Decisions are bit-identical to `viterbi_forward` (ties favor the low
    source: `a[0] > a[1]`, viterbiDecoderButterflyk1.c:129).

    Returns (decisions uint8 [T, num_states], final_metrics int32 [NS]).
    """
    spec.validate_for_butterfly()
    NS = spec.num_states
    half = NS // 2
    bfly = jnp.asarray(butterfly_coded_bits(spec), jnp.int32)  # [half]
    # Bits of the butterfly's reference coded segment, one plane per coded bit.
    cbits = jnp.stack([(bfly >> j) & 1 for j in range(spec.n)])  # [n, half]

    if initial_metrics is None:
        init = jnp.full((NS,), init_metric_value(spec), dtype=jnp.int32)
        init = init.at[spec.starting_state].set(0)
    else:
        init = jnp.asarray(initial_metrics, jnp.int32)

    def step(m, seg):
        rbits = jnp.stack([(seg >> j) & 1 for j in range(spec.n)])  # [n]
        em = jnp.sum(cbits ^ rbits[:, None], axis=0)                # [half]
        emc = spec.n - em
        m_lo, m_hi = m[:half], m[half:]
        a0 = m_lo + em
        a1 = m_hi + emc
        b0 = m_lo + emc
        b1 = m_hi + em
        a_dec = (a0 > a1).astype(jnp.uint8)
        b_dec = (b0 > b1).astype(jnp.uint8)
        new_even = jnp.minimum(a0, a1)   # dst = 2b
        new_odd = jnp.minimum(b0, b1)    # dst = 2b+1
        new_m = jnp.stack([new_even, new_odd], axis=1).reshape(NS)
        dec = jnp.stack([a_dec, b_dec], axis=1).reshape(NS)
        return new_m, dec

    final_m, decisions = jax.lax.scan(
        step, init, jnp.asarray(segments, jnp.int32))
    return decisions, final_m


@functools.partial(jax.jit, static_argnums=(0, 2))
def traceback_terminated(spec: CodeSpec, decisions, num_pad: int = -1,
                         start_state=0):
    """Block traceback from state 0 over a terminated packet.

    Twin of the butterfly decoder's deferred traceback
    (viterbiDecoderButterflyk1.c:200-260): walk backward from the known final
    state 0, reconstructing sources via
    ``src = (dst >> k) | (decision << (S-1)*k)`` and emitting the k input
    bits ``dst & (2^k - 1)`` per step; the last `num_pad` (= S) steps are the
    termination padding and produce no output.

    Returns uint8 [ (T - num_pad) * k ] decoded bits, MSb of each k-bit
    symbol first (matching the encoder's big-endian symbol order,
    convEncode.h:52).

    `start_state` (traced ok) overrides the known terminal state 0 — the
    truncation-decode start (argmin of final metrics, viterbiDecoder.c:53-74)
    used by tail-biting wrap decoding.
    """
    if num_pad < 0:
        num_pad = spec.S
    NS = spec.num_states
    E = spec.num_edges_per_state
    shift = (spec.S - 1) * spec.k

    def step(cur, dec_t):
        e = dec_t[cur].astype(jnp.int32)
        u = cur & (E - 1)
        nxt = (cur >> spec.k) | (e << shift)
        return nxt, u

    _, us = jax.lax.scan(step, jnp.asarray(start_state, jnp.int32),
                         jnp.asarray(decisions), reverse=True)
    us = us[: us.shape[0] - num_pad]  # drop padding steps (the trailing S)
    # Expand each k-bit symbol MSb-first.
    bit_idx = jnp.arange(spec.k - 1, -1, -1, dtype=jnp.int32)
    bits = ((us[:, None] >> bit_idx) & 1).astype(jnp.uint8)
    return bits.reshape(-1)


@functools.partial(jax.jit, static_argnums=(0, 2))
def viterbi_decode(spec: CodeSpec, segments, use_butterfly: bool | None = None):
    """Hard-decision block decode of one terminated packet.

    Dispatches to the butterfly formulation when k == 1 and the generators
    have poly symmetry, else the generic decoder — the reference's
    VITERBI_DECODER_HARD dispatch (viterbiDecoder.h:87-95) as a runtime rule.

    Args:
      segments: uint8 [T] hard n-bit segments (T = L/k + S).
    Returns:
      uint8 [L*... ] decoded bits ((T - S) * k of them).
    """
    if use_butterfly is None:
        use_butterfly = spec.k == 1 and spec.has_poly_symmetry
    if use_butterfly:
        decisions, _ = viterbi_forward_butterfly(spec, segments)
    else:
        bm = hard_step_metrics(spec, segments)
        decisions, _ = viterbi_forward(spec, bm)
    return traceback_terminated(spec, decisions)


@functools.partial(jax.jit, static_argnums=(0,))
def viterbi_decode_ragged(spec: CodeSpec, segments, seg_lengths):
    """Batched decode of terminated packets with PER-CHANNEL lengths.

    The reference decodes one packet per call, so ragged traffic costs one
    call per length (`viterbiDecoderHardButterflyk1`'s whole-packet `last`
    contract, viterbiDecoderButterflyk1.c:82-260); here a single batched
    trace handles mixed lengths: decisions at steps >= t_b are masked to
    decision 0, and because every trellis state is a shift register,
    state 0 is a fixed point of decision 0 — the backward walk parked at
    state 0 over the masked tail arrives at step t_b-1 still in the
    channel's true terminal state (the per-packet known-final-state start,
    viterbiDecoderButterflyk1.c:200-212).

    Args:
      segments: uint8 [B, Tmax] hard segments; rows may be padded with
        anything beyond t_b.
      seg_lengths: int32 [B] (traced ok) valid segment counts,
        t_b = l_b / k + S for an l_b-bit message.
    Returns:
      uint8 [B, (Tmax - S) * k] decoded bits; positions >= (t_b - S)*k
      of each row are zero.
    """
    segments = jnp.asarray(segments, jnp.uint8)
    B, T = segments.shape
    lens = jnp.asarray(seg_lengths, jnp.int32)
    if spec.k == 1 and spec.has_poly_symmetry:
        decisions, _ = jax.vmap(
            lambda s: viterbi_forward_butterfly(spec, s))(segments)
    else:
        decisions, _ = jax.vmap(
            lambda s: viterbi_forward(spec, hard_step_metrics(spec, s))
        )(segments)
    return ragged_epilogue(spec, decisions, lens, T)


def ragged_epilogue(spec: CodeSpec, decisions, lens, T: int):
    """Shared tail of the ragged decoders (hard here, soft in
    ops/metrics.py): zero decisions past each row's length (the
    decision-0 fixed point walks padded steps in place), run the
    terminated traceback, then zero the termination symbols and
    everything beyond — only the first (t_b - S)*k positions are
    message bits (viterbiDecoder.c:206-210's pad stripping, per
    channel)."""
    live = jnp.arange(T, dtype=jnp.int32)[None, :] < lens[:, None]
    decisions = decisions * live[:, :, None].astype(jnp.uint8)
    bits = jax.vmap(
        lambda d: traceback_terminated(spec, d, num_pad=0))(decisions)
    pos = jnp.arange(T * spec.k, dtype=jnp.int32)
    msg_live = pos[None, :] < (lens[:, None] - spec.S) * spec.k
    bits = bits * msg_live.astype(jnp.uint8)
    return bits[:, : (T - spec.S) * spec.k]


@functools.partial(jax.jit, static_argnums=(0, 2))
def viterbi_decode_stream(spec: CodeSpec, segments, traceback_len: int = 0):
    """Streaming sliding-window decode (decode delay = traceback_len).

    Register-exchange formulation of the generic decoder's streaming
    traceback (viterbiDecoder.c:122-125,140-190): each state carries the last
    `traceback_len` decoded symbols of its survivor path; once warmed up,
    each step emits the oldest symbol from the current argmin state's
    register; at packet end the remaining symbols are flushed from state 0's
    register, minus the S padding steps (viterbiDecoder.c:194-221).

    Requires T >= traceback_len.  Returns uint8 [(T - S) * k] decoded bits.
    """
    segments = jnp.asarray(segments)
    bm_all = hard_step_metrics(spec, segments)
    return _decode_stream_from_bm(spec, bm_all, traceback_len)


@functools.partial(jax.jit, static_argnums=(0, 2))
def viterbi_decode_stream_soft(spec: CodeSpec, qllrs,
                               traceback_len: int = 0):
    """Soft-decision streaming sliding-window decode.

    `viterbi_decode_stream` with quantized-LLR branch costs
    (ops/metrics.soft_step_metrics) in place of Hamming metrics — the
    same per-step argmin emit and state-0 flush.  Hard ±1 pseudo-LLRs
    decode identically to the hard streaming decoder.

    Args:
      qllrs: int [T, n] quantized LLRs.
    Returns uint8 [(T - S) * k] decoded bits.
    """
    from .metrics import soft_step_metrics
    bm_all = soft_step_metrics(spec, qllrs)
    return _decode_stream_from_bm(spec, bm_all, traceback_len)


def _decode_stream_from_bm(spec: CodeSpec, bm_all, traceback_len: int):
    """Shared streaming register-exchange core over per-step branch
    metrics bm_all int32 [T, 2^k, NS]."""
    W = traceback_len or spec.traceback_len
    NS = spec.num_states
    E = spec.num_edges_per_state
    T = bm_all.shape[0]
    if T < W:
        raise ValueError(f"packet of {T} segments shorter than traceback {W}")
    if W <= spec.S:
        # The flush emits state 0's register columns W-2 .. S; with
        # W <= S that window is empty and the streamed prefix would
        # include decoded termination steps as message symbols.
        raise ValueError(f"traceback_len {W} must exceed S = {spec.S} "
                         "(the flush drops the S termination steps from "
                         "the register window, viterbiDecoder.c:194-221)")

    prev = jnp.asarray(prev_state_table(spec))
    u_of_dst = jnp.arange(NS, dtype=jnp.int32) & (E - 1)
    bm_idx = u_of_dst[None, :] * NS + prev

    init_m = jnp.full((NS,), init_metric_value(spec), dtype=jnp.int32)
    init_m = init_m.at[spec.starting_state].set(0)
    init_reg = jnp.zeros((NS, W), dtype=jnp.uint8)  # newest symbol at col 0

    def step(carry, bm_t):
        m, reg = carry
        pm = m[prev] + bm_t.reshape(-1)[bm_idx]
        dec = jnp.argmin(pm, axis=0)
        new_m = jnp.min(pm, axis=0)
        src = prev[dec, jnp.arange(NS)]
        new_reg = jnp.concatenate(
            [u_of_dst[:, None].astype(jnp.uint8), reg[src, : W - 1]], axis=1)
        best = jnp.argmin(new_m)           # argminNodeMetrics: first min
        emit = new_reg[best, W - 1]        # depth traceback_len - 1
        return (new_m, new_reg), emit

    (final_m, final_reg), emitted = jax.lax.scan(step, (init_m, init_reg),
                                                 bm_all)
    # Streamed symbols cover steps 0 .. T-W (emitted[t] valid for t >= W-1).
    streamed = emitted[W - 1:]
    # Flush: state 0's register columns W-2 .. S = steps T-W+1 .. T-1-S.
    flush = final_reg[0, spec.S:W - 1][::-1]
    us = jnp.concatenate([streamed, flush])
    bit_idx = jnp.arange(spec.k - 1, -1, -1, dtype=jnp.int32)
    bits = ((us[:, None].astype(jnp.int32) >> bit_idx) & 1).astype(jnp.uint8)
    return bits.reshape(-1)


@functools.partial(jax.jit, static_argnums=(0, 2))
def viterbi_decode_bytes(spec: CodeSpec, segments,
                         message_bits: int | None = None):
    """Hard-decision block decode to packed bytes.

    The byte twin of `viterbi_decode`, mirroring `encode_bytes`: decoded
    bits fill bytes MSb-first (viterbiDecoderButterflyk1.c:245-249); a
    trailing partial byte is zero-padded.  When 8 % k != 0, decoded k-bit
    symbols straddle byte boundaries exactly as the reference's spillover
    path does (viterbiDecoder.c:152-189).

    Returns uint8 [ceil(L_bits / 8)] packed bytes.
    """
    from .bits import pack_bits
    bits = viterbi_decode(spec, segments)
    L = message_bits if message_bits is not None else bits.shape[-1]
    bits = bits[..., :L]
    pad = (-L) % 8
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    return pack_bits(bits)
