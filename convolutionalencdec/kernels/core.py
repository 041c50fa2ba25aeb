"""Batched k=1 butterfly Viterbi core for Hopper (Pallas, Triton route).

Two operations, each one `pallas_call(backend="triton")`:

* `acs_forward` — the butterfly add-compare-select recurrence
  (viterbiDecoderButterflyk1.c:82-196) from given initial metrics over a
  batch of channels; returns bit-packed survivor decisions and the final
  path metrics.
* `traceback` — the backward walk (viterbiDecoderButterflyk1.c:200-260)
  from given per-channel start states and end steps, emitting decoded
  bits as MSb-first bytes below a per-channel emit bound.

Block, ragged, punctured, streaming and time-sharded decode are built from
these two.

Design:

* Grid over channel tiles only (`TILE` channels per program); time is a
  `lax.fori_loop` inside the kernel, so the path metrics stay in registers
  for the whole packet and one launch covers every step.
* Inputs are time-major ([T, B] hard segments, [n, T, B] soft LLR
  planes), so each step's load is one contiguous row across the tile.
  The next step's row (the traceback: the next 8 steps' rows) is loaded
  one iteration ahead.
* Metrics are int32 and never renormalized: they grow by at most
  n * 128 per step, so a call stays exact for T < 2^31 / (128 n) steps.
  Only metric differences matter, so carried metrics may be shifted by
  the caller between calls.
* Decisions are int32 [T, B, NW] in butterfly order: bit j of word
  2w + p is the decision of destination state 2(BW w + j) + p.  The ACS
  produces the even and odd destinations apart, and the traceback reads
  the survivor bit of state s with one select and one shift.

On any platform other than the GPU the same operations run as plain
`lax.scan` references with identical outputs (`use_kernel` is the one
place that chooses).  `interpret=True` runs the Pallas kernels in the
interpreter; only tests ask for it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..params import CodeSpec
from ..ops.trellis import butterfly_coded_bits
from ..ops.viterbi import init_metric_value

#: Channels per program.  Each step is latency-bound, so several small
#: programs per SM hide each other's latency: on an H100 80GB HBM3
#: (700 W limit) at B=2048, L=2048, one hard decode call took 2.43 ms of
#: wall time at 16 channels, 1.49 ms at 8 and 1.04 ms at 4 (one warp
#: each); 2 channels was no faster than 4.
TILE = 4
#: Warps per program.
NUM_WARPS = 1
#: Forward steps per loop iteration: on an H100 80GB HBM3 (400 W limit)
#: at B=2048, L=2048, two steps per iteration cut a forward call from
#: 0.825 ms to 0.711 ms of wall time.
STEPS_PER_ITER = 2


def supported(spec: CodeSpec) -> bool:
    """Codes the core decodes: k=1 with poly symmetry (the butterfly)."""
    return spec.k == 1 and spec.has_poly_symmetry


def use_kernel(spec: CodeSpec) -> bool:
    """The backend choice: the Hopper core on the GPU, the scan elsewhere."""
    return supported(spec) and jax.default_backend() == "gpu"


def _layout(spec: CodeSpec):
    """(H, BW, WH): butterflies, decision bits per word, words per parity."""
    H = spec.num_states // 2
    BW = min(H, 32)
    return H, BW, H // BW


def num_words(spec: CodeSpec) -> int:
    """Decision words per channel-step."""
    return 2 * _layout(spec)[2]


def _pad_channels(x, axis: int):
    pad = (-x.shape[axis]) % TILE
    if not pad:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def standard_init(spec: CodeSpec, batch: int):
    """Known-start metrics (0 at state 0, forceNot elsewhere,
    viterbiDecoder.c:246-249), int32 [batch, NS]."""
    m = np.full((spec.num_states,), init_metric_value(spec), np.int32)
    m[spec.starting_state] = 0
    return jnp.broadcast_to(jnp.asarray(m), (batch, spec.num_states))


def bytes_to_bits(by, L: int):
    """uint8 [B, nbytes] MSb-first bytes -> uint8 [B, L] bits."""
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (by[:, :, None] >> shifts) & 1
    return bits.reshape(by.shape[0], -1)[:, :L]


def as_int8_llrs(q):
    """Quantized LLRs saturated to the int8 range the core reads."""
    q = jnp.asarray(q)
    if q.dtype == jnp.int8:
        return q
    return jnp.clip(q.astype(jnp.int32), -128, 127).astype(jnp.int8)


# ---------------------------------------------------------------------------
# Kernels


def _forward_kernel(spec: CodeSpec, T: int, soft: bool):
    H, BW, WH = _layout(spec)
    NS, n = spec.num_states, spec.n

    def load(x_ref, t, b0):
        if soft:
            return tuple(x_ref[j, t, pl.ds(b0, TILE)].astype(jnp.int32)
                         for j in range(n))
        return x_ref[t, pl.ds(b0, TILE)].astype(jnp.int32)

    def pack(d):
        d = d.astype(jnp.int32).reshape(TILE, WH, BW)
        return jnp.sum(d << jnp.arange(BW, dtype=jnp.int32), axis=2)

    def kernel(cb_ref, x_ref, m0_ref, dec_ref, mf_ref):
        b0 = pl.program_id(0) * TILE
        cb = cb_ref[...][None, :]                        # [1, H]

        def step(t, m, x):
            if soft:
                em = jnp.zeros((TILE, H), jnp.int32)
                total = jnp.zeros((TILE, 1), jnp.int32)
                for j in range(n):
                    q = x[j][:, None]
                    rp, rn = jnp.maximum(q, 0), jnp.maximum(-q, 0)
                    em = em + rn + ((cb >> j) & 1) * (rp - rn)
                    total = total + rp + rn
                emc = total - em
            else:
                diff = x[:, None] ^ cb
                em = diff & 1
                for j in range(1, n):
                    em = em + ((diff >> j) & 1)
                emc = n - em
            lo, hi = jnp.split(m, 2, axis=1)             # sources b, b + H
            a0, a1 = lo + em, hi + emc                   # into 2b
            c0, c1 = lo + emc, hi + em                   # into 2b + 1
            da, dc = a0 > a1, c0 > c1                    # ties keep low source
            m = jnp.stack([jnp.minimum(a0, a1), jnp.minimum(c0, c1)],
                          axis=2).reshape(TILE, NS)
            words = jnp.stack([pack(da), pack(dc)], axis=2)
            dec_ref[t, pl.ds(b0, TILE), :] = words.reshape(TILE, 2 * WH)
            return m

        def steps(t0, carry):
            m, x = carry
            for u in range(STEPS_PER_ITER):
                t = t0 + u
                x_next = load(x_ref, jnp.minimum(t + 1, T - 1), b0)
                m, x = step(t, m, x), x_next
            return m, x

        carry = (m0_ref[pl.ds(b0, TILE), :], load(x_ref, 0, b0))
        n_iter = T // STEPS_PER_ITER
        m, x = jax.lax.fori_loop(
            0, n_iter, lambda i, c: steps(i * STEPS_PER_ITER, c), carry)
        for t in range(n_iter * STEPS_PER_ITER, T):      # static tail
            m, x = step(t, m, x), load(x_ref, min(t + 1, T - 1), b0)
        mf_ref[pl.ds(b0, TILE), :] = m

    return kernel


def _traceback_kernel(spec: CodeSpec, T: int, NB: int):
    H, BW, WH = _layout(spec)
    NW, S = 2 * WH, spec.S

    def load(dec_ref, g, b0):
        """Decision rows of byte group g (steps 8g .. 8g + 7)."""
        return tuple(dec_ref[jnp.clip(g * 8 + i, 0, T - 1), pl.ds(b0, TILE), :]
                     for i in range(8))

    def kernel(dec_ref, s0_ref, end_ref, emit_ref, out_ref):
        b0 = pl.program_id(0) * TILE
        end = end_ref[pl.ds(b0, TILE)]
        emit = emit_ref[pl.ds(b0, TILE)]
        w_iota = jnp.arange(NW, dtype=jnp.int32)[None, :]

        def group(gi, carry):
            s, rows = carry
            g = NB - 1 - gi
            rows_next = load(dec_ref, g - 1, b0)
            acc = jnp.zeros((TILE,), jnp.int32)
            for i in range(7, -1, -1):
                t = g * 8 + i
                words = rows[i]
                half = s >> 1
                widx = (half // BW) * 2 + (s & 1)
                word = jnp.sum(jnp.where(w_iota == widx[:, None], words, 0),
                               axis=1)
                bit = (word >> (half & (BW - 1))) & 1
                live = t < end
                acc = acc | (jnp.where(live & (t < emit), s & 1, 0) << (7 - i))
                s = jnp.where(live, half | (bit << (S - 1)), s)
            out_ref[g, pl.ds(b0, TILE)] = acc.astype(jnp.uint8)
            return s, rows_next

        jax.lax.fori_loop(0, NB, group, (s0_ref[pl.ds(b0, TILE)],
                                         load(dec_ref, NB - 1, b0)))

    return kernel


def _compiler_params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def _forward_pallas(spec, xt, m0, soft: bool, interpret: bool):
    T, Bp = xt.shape[-2:]
    cb = jnp.asarray(butterfly_coded_bits(spec).astype(np.int32))
    return pl.pallas_call(
        _forward_kernel(spec, T, soft),
        out_shape=(jax.ShapeDtypeStruct((T, Bp, num_words(spec)), jnp.int32),
                   jax.ShapeDtypeStruct((Bp, spec.num_states), jnp.int32)),
        grid=(Bp // TILE,),
        compiler_params=_compiler_params(),
        backend="triton",
        interpret=interpret,
        name="viterbi_acs_forward",
    )(cb, xt, m0)


def _traceback_pallas(spec, dec, s0, end, emit, interpret: bool):
    T, Bp, _ = dec.shape
    NB = -(-T // 8)
    return pl.pallas_call(
        _traceback_kernel(spec, T, NB),
        out_shape=jax.ShapeDtypeStruct((NB, Bp), jnp.uint8),
        grid=(Bp // TILE,),
        compiler_params=_compiler_params(),
        backend="triton",
        interpret=interpret,
        name="viterbi_traceback",
    )(dec, s0, end, emit)


# ---------------------------------------------------------------------------
# Plain lax.scan references with the same outputs (every other platform)


def _forward_scan(spec, xt, m0, soft: bool):
    from ..ops.metrics import viterbi_forward_butterfly_soft
    from ..ops.viterbi import viterbi_forward_butterfly
    H, BW, WH = _layout(spec)
    if soft:
        dec, fm = jax.vmap(
            lambda q, m: viterbi_forward_butterfly_soft(spec, q, m),
            in_axes=(1, 0))(jnp.moveaxis(xt, 0, -1), m0)
    else:
        dec, fm = jax.vmap(
            lambda s, m: viterbi_forward_butterfly(spec, s, m),
            in_axes=(1, 0))(xt, m0)
    B, T = dec.shape[:2]                                 # dec [B, T, NS]
    d = dec.astype(jnp.int32).reshape(B, T, WH, BW, 2)
    shifts = jnp.arange(BW, dtype=jnp.int32)[:, None]
    words = jnp.sum(d << shifts, axis=3).reshape(B, T, 2 * WH)
    return jnp.transpose(words, (1, 0, 2)), fm


def _traceback_scan(spec, dec, s0, end, emit):
    from ..ops.bits import pack_bits
    H, BW, WH = _layout(spec)
    T = dec.shape[0]
    t_idx = jnp.arange(T, dtype=jnp.int32)

    def one(words, s, e, m):
        def step(s, inp):
            t, w = inp
            half = s >> 1
            word = w[(half // BW) * 2 + (s & 1)]
            bit = (word >> (half & (BW - 1))) & 1
            live = t < e
            u = jnp.where(live & (t < m), s & 1, 0).astype(jnp.uint8)
            return jnp.where(live, half | (bit << (spec.S - 1)), s), u

        return jax.lax.scan(step, s, (t_idx, words), reverse=True)[1]

    bits = jax.vmap(one, in_axes=(1, 0, 0, 0))(dec, s0, end, emit)
    pad = (-T) % 8
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    return pack_bits(bits).T                             # [NB, Bp]


# ---------------------------------------------------------------------------
# The two operations


@functools.partial(jax.jit, static_argnums=(0,),
                   static_argnames=("interpret",))
def acs_forward(spec: CodeSpec, x, init_metrics=None, *,
                interpret: bool = False):
    """Forward ACS over a batch.

    Args:
      x: hard uint8 [B, T] segments, or soft int [B, T, n] quantized LLRs
        (saturated to int8; zero is an erasure).
      init_metrics: int32 [B, NS] starting path metrics; default the
        known start (`standard_init`).
    Returns:
      (decisions int32 [T, Bp, NW] with Bp = B rounded up to `TILE`,
       final metrics int32 [B, NS]).
    """
    spec.validate_for_butterfly()
    soft = x.ndim == 3
    if soft:
        if x.shape[-1] != spec.n:
            raise ValueError(f"soft input last dim {x.shape[-1]} != n={spec.n}")
        xt = jnp.transpose(as_int8_llrs(x), (2, 1, 0))    # [n, T, B]
    else:
        xt = jnp.asarray(x, jnp.uint8).T                  # [T, B]
    B = x.shape[0]
    m0 = (standard_init(spec, B) if init_metrics is None
          else jnp.asarray(init_metrics, jnp.int32))
    xt = _pad_channels(xt, xt.ndim - 1)
    m0 = _pad_channels(m0, 0)
    if interpret or use_kernel(spec):
        dec, fm = _forward_pallas(spec, xt, m0, soft, interpret)
    else:
        dec, fm = _forward_scan(spec, xt, m0, soft)
    return dec, fm[:B]


@functools.partial(jax.jit, static_argnums=(0,),
                   static_argnames=("interpret",))
def traceback(spec: CodeSpec, decisions, start_state, end, emit_end, *,
              interpret: bool = False):
    """Backward walk over `acs_forward` decisions.

    Channel b starts in `start_state[b]` after step `end[b] - 1` and walks
    back to step 0; steps at or past `end[b]` are skipped.  The decoded
    bit of step t is emitted where t < `emit_end[b]`, else zero.

    Args:
      decisions: int32 [T, Bp, NW] from `acs_forward`.
      start_state, end, emit_end: int [B] with B <= Bp.
    Returns:
      uint8 [B, ceil(T / 8)] bytes, bit t at byte t // 8, MSb first
      (viterbiDecoderButterflyk1.c:245-249).
    """
    B = start_state.shape[0]
    Bp = decisions.shape[1]
    args = [jnp.pad(jnp.asarray(a, jnp.int32), (0, Bp - B))
            for a in (start_state, end, emit_end)]
    if interpret or use_kernel(spec):
        out = _traceback_pallas(spec, decisions, *args, interpret)
    else:
        out = _traceback_scan(spec, decisions, *args)
    return out[:, :B].T


def decode_bytes(spec: CodeSpec, x, end=None, emit_end=None, *,
                 interpret: bool = False):
    """Terminated block decode to bytes: known-start forward, then a walk
    from state 0 after step `end - 1` (default T) emitting `emit_end`
    (default end - S) message bits.  Returns uint8 [B, ceil(T / 8)]."""
    dec, _ = acs_forward(spec, x, interpret=interpret)
    B, T = x.shape[:2]
    if end is None:
        end = jnp.full((B,), T, jnp.int32)
    end = jnp.asarray(end, jnp.int32)
    if emit_end is None:
        emit_end = end - spec.S
    return traceback(spec, dec, jnp.zeros((B,), jnp.int32), end, emit_end,
                     interpret=interpret)
