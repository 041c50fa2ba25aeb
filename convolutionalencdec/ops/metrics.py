"""Soft-decision branch metrics (quantized LLRs).

The reference is hard-decision only (Hamming metrics,
viterbiDecoder.c:260-285); its MATLAB companion documents the ~2 dB soft
gain (berCurveCoded.m:46-51 computes both hard and soft curves).  This
module adds the soft path the framework needs for BER-curve parity with
the analytic soft expectations:

  * channel LLRs (ops/channel.py `bpsk_llr`) are quantized to small signed
    integers, so the ACS kernels keep narrow integer metrics;
  * the branch cost of assuming coded bit b given quantized LLR q is
    0 if sign(q) agrees with b else |q| — for hard inputs (q = ±1) this
    reduces exactly to the Hamming metric, so one ACS implementation
    serves both;
  * a zero LLR is an *erasure*: it contributes no cost to either
    hypothesis.  Depunctured positions use this (ops/puncture.py).

The butterfly complement identity survives: for a step with quantized LLRs
q_j, cost(edge) + cost(complement edge) = sum_j |q_j| =: Q, so the
poly-symmetry trick (viterbiDecoder.h:33-39) becomes emc = Q - em with a
per-step scalar Q instead of the constant n.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec
from .trellis import butterfly_coded_bits, edge_coded_bits
from .viterbi import init_metric_value, traceback_terminated

#: Default quantizer ceiling.  What qmax=7 bounds is the metric *spread*
#: (<= qmax*n*S), which `init_metric_value`'s clamp relies on.  The
#: decoders are exact for any int8 LLR; 3-bit magnitudes give up only
#: ~0.1-0.2 dB versus unquantized soft decoding.
DEFAULT_QMAX = 7


def quantize_llrs(llrs, qmax: int = DEFAULT_QMAX, scale: float | None = None):
    """Quantize float LLRs to signed integers in [-qmax, qmax].

    Args:
      llrs: float [..., n_bits]; positive favors bit 0.
      scale: LLR units per quantizer step.  Default picks 3 sigma of the
        incoming LLRs mapped onto qmax (a robust automatic gain control).
    Returns:
      int32 array, same shape.
    """
    llrs = jnp.asarray(llrs, jnp.float32)
    if scale is None:
        scale = 3.0 * jnp.sqrt(jnp.mean(jnp.square(llrs))) / qmax
        scale = jnp.maximum(scale, 1e-9)
    q = jnp.round(llrs / scale)
    return jnp.clip(q, -qmax, qmax).astype(jnp.int32)


def soft_step_metrics(spec: CodeSpec, qllrs) -> jnp.ndarray:
    """Per-step branch metrics from quantized LLRs, for `viterbi_forward`.

    Args:
      qllrs: int [..., T, n] quantized LLRs, one per coded bit of each
        segment, bit j of the segment at position j (the encoder packs
        generator j at bit j, convEncode.c:155-159).
    Returns:
      int32 [..., T, 2^k, num_states] additive branch costs.
    """
    qllrs = jnp.asarray(qllrs, jnp.int32)
    ec = edge_coded_bits(spec)  # [2^k, NS]
    out = jnp.zeros(qllrs.shape[:-1] + ec.shape, jnp.int32)
    for j in range(spec.n):
        bit_j = jnp.asarray(((ec >> j) & 1).astype(np.int32))  # [2^k, NS]
        q = qllrs[..., j][..., None, None]
        # cost(bit) = relu(q) if bit == 1 else relu(-q)
        out = out + jnp.where(bit_j == 1, jnp.maximum(q, 0),
                              jnp.maximum(-q, 0))
    return out


@functools.partial(jax.jit, static_argnums=(0,))
def viterbi_forward_butterfly_soft(spec: CodeSpec, qllrs,
                                   initial_metrics=None):
    """k=1 butterfly ACS on quantized LLRs.

    Same wiring as `viterbi_forward_butterfly` with the soft complement
    emc = Q - em (Q = per-step sum of |q_j|); `initial_metrics` as
    there.  Returns (decisions uint8 [T, NS], final_metrics int32 [NS]).
    """
    spec.validate_for_butterfly()
    NS = spec.num_states
    half = NS // 2
    bfly = butterfly_coded_bits(spec)
    cbits = jnp.asarray(
        np.stack([(bfly >> j) & 1 for j in range(spec.n)]).astype(np.int32))

    if initial_metrics is None:
        init = jnp.full((NS,), init_metric_value(spec), dtype=jnp.int32)
        init = init.at[spec.starting_state].set(0)
    else:
        init = jnp.asarray(initial_metrics, jnp.int32)

    def step(m, q_t):  # q_t: [n]
        # em[b] = sum_j cost_j(cbits[j, b])
        em = jnp.zeros((half,), jnp.int32)
        Q = jnp.sum(jnp.abs(q_t))
        for j in range(spec.n):
            em = em + jnp.where(cbits[j] == 1, jnp.maximum(q_t[j], 0),
                                jnp.maximum(-q_t[j], 0))
        emc = Q - em
        m_lo, m_hi = m[:half], m[half:]
        a0 = m_lo + em
        a1 = m_hi + emc
        b0 = m_lo + emc
        b1 = m_hi + em
        a_dec = (a0 > a1).astype(jnp.uint8)
        b_dec = (b0 > b1).astype(jnp.uint8)
        new_m = jnp.stack([jnp.minimum(a0, a1), jnp.minimum(b0, b1)],
                          axis=1).reshape(NS)
        dec = jnp.stack([a_dec, b_dec], axis=1).reshape(NS)
        return new_m, dec

    final_m, decisions = jax.lax.scan(step, init,
                                      jnp.asarray(qllrs, jnp.int32))
    return decisions, final_m


@functools.partial(jax.jit, static_argnums=(0,))
def viterbi_decode_soft(spec: CodeSpec, qllrs):
    """Soft-decision block decode of one terminated packet.

    Args:
      qllrs: int [T, n] quantized LLRs (use `quantize_llrs` on channel
        LLRs; hard bits map to q = 1 - 2*bit).
    Returns:
      uint8 [(T - S) * k] decoded message bits.
    """
    if spec.k == 1 and spec.has_poly_symmetry:
        decisions, _ = viterbi_forward_butterfly_soft(spec, qllrs)
    else:
        from .viterbi import viterbi_forward
        bm = soft_step_metrics(spec, qllrs)
        decisions, _ = viterbi_forward(spec, bm)
    return traceback_terminated(spec, decisions)


@functools.partial(jax.jit, static_argnums=(0,))
def viterbi_decode_ragged_soft(spec: CodeSpec, qllrs, seg_lengths):
    """Soft-decision batched decode with per-channel lengths.

    The soft twin of ops/viterbi.viterbi_decode_ragged (same
    masked-decision walk — see its docstring for the fixed-point
    argument).

    Args:
      qllrs: int8 [B, Tmax, n] quantized LLRs.
      seg_lengths: int32 [B] (traced ok) valid segment counts.
    Returns:
      uint8 [B, (Tmax - S) * k]; positions >= (t_b - S)*k are zero.
    """
    from .viterbi import ragged_epilogue, viterbi_forward
    qllrs = jnp.asarray(qllrs, jnp.int8)
    B, T, _ = qllrs.shape
    lens = jnp.asarray(seg_lengths, jnp.int32)
    if spec.k == 1 and spec.has_poly_symmetry:
        decisions, _ = jax.vmap(
            lambda q: viterbi_forward_butterfly_soft(spec, q))(qllrs)
    else:
        decisions, _ = jax.vmap(
            lambda q: viterbi_forward(spec, soft_step_metrics(spec, q))
        )(qllrs)
    return ragged_epilogue(spec, decisions, lens, T)


def hard_bits_to_qllrs(segment_bits):
    """Map hard coded bits to ±1 pseudo-LLRs (bit 0 -> +1, bit 1 -> -1).

    Soft decoding of these is decision-identical to Hamming-metric hard
    decoding (costs are 0/1 per bit, exactly the Hamming contribution).
    """
    return 1 - 2 * jnp.asarray(segment_bits, jnp.int32)
