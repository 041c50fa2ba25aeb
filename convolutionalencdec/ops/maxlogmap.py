"""Max-log-MAP (min-sum BCJR) soft-output decoding.

Beyond-reference capability: the reference's Viterbi decoder
(viterbiDecoder.c:52-234) emits hard sequence decisions only.  Soft
*outputs* — a posteriori per-bit reliabilities — are what turbo
equalization / iterative receivers consume (the SOVA/BCJR family).  This
module implements the max-log approximation in the min-sum cost domain
shared with the Viterbi path (ops/metrics.soft_step_metrics):

    alpha_{t+1}(d) = min_e [ alpha_t(src(e,d)) + bm_t(u(d), src(e,d)) ]
    beta_t(s)      = min_u [ bm_t(u, s) + beta_{t+1}(next(u, s)) ]
    L_t(bit j)     = min over edges with u_j = 1 of
                         [ alpha_t(s) + bm_t(u, s) + beta_{t+1}(next) ]
                   - the same min over edges with u_j = 0

so positive LLRs favor bit 0, matching the input-LLR convention
(ops/channel.bpsk_llr, ops/metrics.quantize_llrs).  All arithmetic is
integer min-sum on the quantized-LLR costs, so outputs are exact
integers — bit-exactly testable against brute-force path enumeration.

The trellis conventions are the reference's (trellis.py: dst =
((s << k) | u) & mask, src = d >> k | e << (S-1)k), and the forward
recurrence is literally `viterbi_forward`'s ACS; the backward pass is
its time-mirror.  The T x NS alpha/beta tensors live in HBM per packet;
for the flagship K=7 code that is NS=64 int32 per step — the same
footprint class as the Viterbi decision matrix (1 byte/state/step).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec
from .trellis import next_state_table, prev_state_table

#: Exclusion constant for impossible states/hypotheses.  Unlike the
#: Viterbi path's `init_metric_value` (the reference's small "forceNot"
#: seed, viterbiDecoder.c:246-249), MAP LLR *values* are the output — a finite start penalty
#: would leak into early-bit reliabilities.  2^28 leaves int32 headroom
#: for alpha+beta+branch sums (path costs are < T*n*127 < 2^20).
BIG = 1 << 28


@functools.partial(jax.jit, static_argnums=(0, 2))
def maxlogmap_llrs(spec: CodeSpec, qllrs, terminated: bool = True):
    """A-posteriori per-bit LLRs of one packet via max-log-MAP.

    Args:
      qllrs: int [T, n] quantized channel LLRs (positive favors coded
        bit 0), e.g. from ops/metrics.quantize_llrs; erasures are 0.
      terminated: the packet ends in the S termination steps driving the
        encoder back to `starting_state` (convEncode.c:101-122); the
        backward pass is then anchored there.  False leaves the final
        state free (truncated streams / time-sharded interior blocks).

    Returns:
      int32 [T * k] extrinsic-inclusive (full a-posteriori) LLRs, one
      per input bit, symbol bits MSb-first.  Positive favors bit 0.
      For a terminated packet the first (T - S)*k entries are the
      message-bit LLRs (termination-step LLRs are appended for
      completeness; they are strongly biased to the known zeros).
    """
    from .metrics import soft_step_metrics
    NS = spec.num_states
    E = spec.num_edges_per_state
    k = spec.k
    bm = soft_step_metrics(spec, qllrs)          # [T, E, NS]
    T = bm.shape[0]
    prev = jnp.asarray(prev_state_table(spec))   # [E, NS] src of (e, dst)
    nxt = jnp.asarray(next_state_table(spec))    # [E, NS] dst of (u, src)
    u_of_dst = jnp.arange(NS, dtype=jnp.int32) & (E - 1)
    bm_idx = u_of_dst[None, :] * NS + prev       # [E, NS] -> bm[t] flat idx

    big = jnp.asarray(BIG, jnp.int32)

    # Forward: collect alpha_t (the metrics BEFORE consuming step t).
    a0 = jnp.full((NS,), big, jnp.int32)
    a0 = a0.at[spec.starting_state].set(0)

    def fstep(m, bm_t):
        pm = m[prev] + bm_t.reshape(-1)[bm_idx]  # [E, NS]
        return jnp.min(pm, axis=0), m

    _, alphas = jax.lax.scan(fstep, a0, bm)      # alphas[t] = alpha_t

    # Backward: beta_t(s) = min_u bm_t(u, s) + beta_{t+1}(nxt[u, s]).
    if terminated:
        bT = jnp.full((NS,), big, jnp.int32)
        bT = bT.at[spec.starting_state].set(0)
    else:
        bT = jnp.zeros((NS,), jnp.int32)

    def bstep(b, bm_t):
        cand = bm_t + b[nxt]                     # [E(=u), NS(=src)]
        return jnp.min(cand, axis=0), cand

    _, cands = jax.lax.scan(bstep, bT, bm, reverse=True)
    # cands[t, u, s] = bm_t(u, s) + beta_{t+1}(next(u, s)); adding
    # alpha_t(s) gives the best total cost through edge (s, u) at t.
    tot = alphas[:, None, :] + cands             # [T, E, NS]
    per_u = jnp.min(tot, axis=2)                 # [T, E]

    # Per input bit j (MSb-first within the k-bit symbol):
    u_vals = jnp.arange(E, dtype=jnp.int32)
    llrs = []
    for j in range(k - 1, -1, -1):
        mask1 = ((u_vals >> j) & 1) == 1
        c1 = jnp.min(jnp.where(mask1, per_u, big * 4), axis=1)
        c0 = jnp.min(jnp.where(mask1, big * 4, per_u), axis=1)
        llrs.append(c1 - c0)
    out = jnp.stack(llrs, axis=1)                # [T, k] MSb-first
    return out.reshape(-1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(0, 2))
def maxlogmap_decode(spec: CodeSpec, qllrs, terminated: bool = True):
    """Hard bitwise-MAP decisions from `maxlogmap_llrs` (negative LLR ->
    bit 1).  Returns uint8 message bits: [(T - S) * k] for a terminated
    packet (the S termination steps are stripped, like the Viterbi
    decoders), or all [T * k] positions when `terminated=False` — a
    truncated stream has no termination steps to strip.  Note bitwise
    MAP can differ from Viterbi's sequence-ML on rare near-tie bits —
    both are correct under their own criterion."""
    llrs = maxlogmap_llrs(spec, qllrs, terminated)
    bits = (llrs < 0).astype(jnp.uint8)
    if not terminated:
        return bits
    L = (qllrs.shape[0] - spec.S) * spec.k
    return bits[:L]


def maxlogmap_llrs_batch(spec: CodeSpec, qllrs, terminated: bool = True):
    """vmap of `maxlogmap_llrs` over a leading batch axis
    ([B, T, n] -> [B, T*k]).

    Inputs are saturated to the symmetric range [-127, 127]: -128 is
    outside the quantizer contract (|q| <= qmax <= 127)."""
    qllrs = jnp.asarray(qllrs)
    if qllrs.ndim != 3 or qllrs.shape[-1] != spec.n:
        raise ValueError(f"qllrs must be [B, T, n={spec.n}]; last dim is "
                         f"{qllrs.shape[-1]} in shape {qllrs.shape}")
    qllrs = jnp.clip(qllrs.astype(jnp.int32), -127, 127)
    return jax.vmap(lambda q: maxlogmap_llrs(spec, q, terminated))(qllrs)
