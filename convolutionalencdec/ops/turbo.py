"""Turbo codes: parallel-concatenated RSC with iterative max-log-MAP.

A beyond-reference model family (the reference's encoder is strictly
feed-forward, `src/convEncode.c:93` — it cannot express
the recursive systematic constituents turbo codes are built from).
This module adds the LTE data-channel code (36.212 §5.1.3.2): two
8-state recursive systematic convolutional (RSC) encoders, g =
(13, 15) octal, coupled by a QPP interleaver, decoded by exchanging
extrinsic LLRs between two max-log-MAP (min-sum BCJR) passes.

Everything lives in the framework's shared integer min-sum cost domain
(`ops/metrics.py`, `ops/maxlogmap.py`): quantized LLRs in, positive
favors bit 0, costs exact in int32 — so every stage is bit-exactly
testable.  The BCJR recurrences are `maxlogmap_llrs`' with two
extensions: an a-priori term on the input bit (the turbo exchange) and
an RSC trellis (input bit ≠ state LSB, so the edge tables carry the
parity and feedback bits explicitly).

Batching: the per-block trellis is tiny (8 states), so throughput
comes from vmap over blocks — the scans vectorize across the batch
axis exactly like the codec's scan references; the whole iterative
decoder jits into one XLA program (a fixed count of iterations
unrolled at trace time, or a `lax.while_loop` under CRC-gated early
termination).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .bits import parity32_np

#: Exclusion constant, same role as ops.maxlogmap.BIG.
BIG = 1 << 28

#: A-priori LLR clamp applied to the extrinsic exchange (this scan and
#: the C++ oracle alike).  Bounds the max-log branch metrics: with
#: |l_apriori| <= 2^17 and the exchange's channel LLRs (|q| <= qmax,
#: plus filler boosts), per-step |bm| <= |l_sys + l_apriori| + |l_par|
#: stays < 2^18, far inside the int32 metrics and the BIG exclusion.
#: Without a clamp the adversarial worst case grows geometrically per
#: iteration (|le| <= ~15 |la| + O(channel)).  At operating magnitudes
#: (qmax = 31 channel LLRs) measured a-priori magnitudes peak ~200 at
#: L = 6144 over 8 iterations — ~3 orders below the clamp — so it
#: never binds in normal service and campaign statistics are
#: untouched.
LA_CLAMP = 1 << 17


@dataclasses.dataclass(frozen=True)
class RscSpec:
    """A rate-1/2 recursive systematic convolutional constituent.

    Polynomials follow the framework's Proakis big-endian convention
    over K bits (MSB = newest input, `params.CodeSpec`): `g_fb` is the
    feedback polynomial g0 (its MSB term is the current input), `g_fw`
    the parity polynomial g1.  Default = the LTE turbo constituent
    (36.212 §5.1.3.2): K=4, g0=13, g1=15 octal, 8 states.
    """
    K: int = 4
    g_fb: int = 0o13
    g_fw: int = 0o15

    def __post_init__(self):
        if not (self.g_fb >> (self.K - 1)) & 1:
            raise ValueError("feedback polynomial must tap the current input")
        for g in (self.g_fb, self.g_fw):
            if g >= (1 << self.K):
                raise ValueError("polynomial wider than K bits")

    @property
    def S(self) -> int:
        return self.K - 1

    @property
    def num_states(self) -> int:
        return 1 << self.S


def rsc_step(rsc: RscSpec, state: int, u: int) -> tuple[int, int, int]:
    """One RSC trellis step.

    The register holds the last S feedback outputs w (newest at MSB,
    like `CodeSpec.delay_width`'s tapped delay).  Returns
    (next_state, systematic_bit, parity_bit)."""
    S = rsc.S
    fb_taps = rsc.g_fb & ((1 << S) - 1)          # D^1..D^S terms
    w = u ^ int(parity32_np(np.uint32(state & fb_taps)))
    window = (w << S) | state                     # K bits, newest at MSB
    z = int(parity32_np(np.uint32(window & rsc.g_fw)))
    nxt = (window >> 1) & ((1 << S) - 1)
    return nxt, u, z


def rsc_tail_input(rsc: RscSpec, state: int) -> int:
    """The input bit that zeroes the feedback (termination: w = 0, so
    the register shifts toward 0; S such steps reach state 0)."""
    fb_taps = rsc.g_fb & ((1 << rsc.S) - 1)
    return int(parity32_np(np.uint32(state & fb_taps)))


@functools.lru_cache(maxsize=None)
def rsc_tables(rsc: RscSpec):
    """Trellis tables: for (u, state) the next state and parity bit;
    plus the per-destination predecessor tables the forward pass
    gathers through.  All derived from `rsc_step` — encoder and
    decoder cannot disagree (the framework's `viterbiInit` rule)."""
    NS = rsc.num_states
    nxt = np.zeros((2, NS), np.int32)
    par = np.zeros((2, NS), np.int32)
    for s in range(NS):
        for u in range(2):
            ns, _, z = rsc_step(rsc, s, u)
            nxt[u, s], par[u, s] = ns, z
    prev = np.zeros((2, NS), np.int32)      # prev[e, d]: e-th predecessor
    pu = np.zeros((2, NS), np.int32)        # input bit on that edge
    fill = np.zeros(NS, np.int64)
    for s in range(NS):
        for u in range(2):
            d = nxt[u, s]
            prev[fill[d], d] = s
            pu[fill[d], d] = u
            fill[d] += 1
    assert (fill == 2).all(), "RSC trellis must be 2-regular"
    return nxt, par, prev, pu


def rsc_encode_np(rsc: RscSpec, bits: np.ndarray):
    """NumPy RSC encode of one block with termination.

    Returns (sys [L], par [L], sys_tail [S], par_tail [S]) — the tail
    systematic bits are the forced termination inputs (transmitted in
    LTE's 12-tail-bit field, not known a priori to the receiver)."""
    bits = np.asarray(bits, np.uint8)
    s = 0
    sys_, par = np.empty_like(bits), np.empty_like(bits)
    for i, u in enumerate(bits):
        s, x, z = rsc_step(rsc, s, int(u))
        sys_[i], par[i] = x, z
    st, pt = np.empty(rsc.S, np.uint8), np.empty(rsc.S, np.uint8)
    for i in range(rsc.S):
        u = rsc_tail_input(rsc, s)
        s, x, z = rsc_step(rsc, s, u)
        st[i], pt[i] = x, z
    assert s == 0
    return sys_, par, st, pt


def rsc_encode_batch_np(rsc: RscSpec, bits: np.ndarray):
    """Vectorized RSC encode of a [B, L] batch (table-driven, one
    NumPy step per trellis step — same outputs as `rsc_encode_np`)."""
    bits = np.asarray(bits, np.uint8)
    B, L = bits.shape
    nxt, par, _, _ = rsc_tables(rsc)
    tail_u = np.array([rsc_tail_input(rsc, s) for s in range(rsc.num_states)],
                      np.uint8)
    s = np.zeros(B, np.int32)
    parity = np.empty((B, L), np.uint8)
    for t in range(L):
        u = bits[:, t]
        parity[:, t] = par[u, s]
        s = nxt[u, s]
    st = np.empty((B, rsc.S), np.uint8)
    pt = np.empty((B, rsc.S), np.uint8)
    for i in range(rsc.S):
        u = tail_u[s]
        st[:, i] = u
        pt[:, i] = par[u, s]
        s = nxt[u, s]
    assert (s == 0).all()
    return bits, parity, st, pt


def turbo_encode_batch_np(rsc: RscSpec, bits: np.ndarray, perm: np.ndarray):
    """Batched `turbo_encode_np`: [B, L] bits -> dict of [B, ...] streams."""
    bits = np.asarray(bits, np.uint8)
    sys_, par1, st1, pt1 = rsc_encode_batch_np(rsc, bits)
    _, par2, st2, pt2 = rsc_encode_batch_np(rsc, bits[:, np.asarray(perm)])
    return {"sys": sys_, "par1": par1, "par2": par2,
            "sys_tail1": st1, "par_tail1": pt1,
            "sys_tail2": st2, "par_tail2": pt2}


# ---------------------------------------------------------------------------
# Matmul RSC encode: the recursion is a GF(2)-LINEAR map of the
# input bits (an IIR filter g_fw(D)/g_fb(D) over GF(2)), so the whole
# recursive encode is ONE binary Toeplitz matmul — the same
# linearity trick ops/crc.py uses for batched CRC.  The impulse
# response h of 1/g_fb is eventually periodic (period | 2^S - 1; 7 for
# the LTE constituent), but the matmul needs no periodicity: h is
# simulated once per (rsc, L) and cached.  No sequential trellis walk
# anywhere — the packet-at-once treatment `ops/encode.py` gives the
# feed-forward reference encoder (src/convEncode.c:
# 46-130), extended to feedback.

def _parity_bits(x, mask: int):
    """Elementwise parity of (x & mask) via unrolled bit XORs."""
    out = None
    b = 0
    while mask >> b:
        if (mask >> b) & 1:
            t = (x >> b) & 1
            out = t if out is None else out ^ t
        b += 1
    return jnp.zeros_like(x) if out is None else out


@functools.lru_cache(maxsize=None)
def _rsc_impulse(rsc: RscSpec, n: int) -> np.ndarray:
    """First n samples of the impulse response of 1/g_fb(D): the
    feedback sequence w for input delta (u_0 = 1)."""
    S = rsc.S
    fb = rsc.g_fb & ((1 << S) - 1)
    h = np.zeros(n, np.uint8)
    s = 0
    for t in range(n):
        u = 1 if t == 0 else 0
        w = u ^ (bin(s & fb).count("1") & 1)
        h[t] = w
        s = ((w << S) | s) >> 1
    return h


#: Toeplitz block edge for the encode matmul: big enough for an
#: efficient matmul, small enough that the baked constants stay tiny
#: (a dense (L, L) constant at L=6144 is 36 M entries).
_ENC_BLOCK = 512


@functools.lru_cache(maxsize=None)
def _rsc_encode_blocks(rsc: RscSpec, L: int):
    """Block-Toeplitz encode operator for (u @ T) & 1.

    The encoder is GF(2)-linear: parity = u convolved with hz, the
    impulse response of g_fw(D)/g_fb(D).  With Kb-wide blocks the
    convolution is nb block-matmuls against only nb DISTINCT (Kb, Kb)
    int8 blocks Td[a, b] = hz[d*Kb + b - a] (Toeplitz), plus a skinny
    (L, S) matrix of h columns for the final-state bits.

    Returns (Td [nb, Kb, Kb] int8, Tt [L, S] int8, Lp).
    """
    S = rsc.S
    Kb = min(_ENC_BLOCK, -(-L // 8) * 8)
    Lp = -(-L // Kb) * Kb
    nb = Lp // Kb
    h = _rsc_impulse(rsc, Lp).astype(np.int64)
    hz = np.zeros(Lp, np.int64)
    for j in range(S + 1):
        if (rsc.g_fw >> j) & 1:
            lag = S - j
            hz[lag:] ^= h[:Lp - lag] if lag else h
    a = np.arange(Kb)[:, None]
    b = np.arange(Kb)[None, :]
    Td = np.zeros((nb, Kb, Kb), np.int8)
    for d in range(nb):
        idx = d * Kb + b - a
        Td[d] = np.where(idx >= 0, hz[np.clip(idx, 0, Lp - 1)], 0)
    j = np.arange(L)[:, None]
    Tt = np.zeros((L, S), np.int8)
    for i in range(S):
        d2 = (L - S + i) - j[:, 0]
        Tt[:, i] = np.where(d2 >= 0, h[np.clip(d2, 0, Lp - 1)], 0)
    return Td, Tt, Lp


@functools.partial(jax.jit, static_argnums=(0,))
def rsc_encode_batch(rsc: RscSpec, bits):
    """Jitted batched RSC encode: [B, L] bits -> (sys, par, st, pt).

    Same outputs as `rsc_encode_batch_np` (which stays as the oracle),
    computed without any sequential recurrence: the encoder is GF(2)-
    linear, so parity is a block-Toeplitz int8 matmul against the
    cached impulse-response blocks, reduced mod 2 — the CRC-as-matmul
    design (ops/crc.py) applied to the whole encoder.  Termination
    fields then follow from the final state in S static steps.
    """
    bits = jnp.asarray(bits, jnp.uint8)
    B, L = bits.shape
    S = rsc.S
    Td_np, Tt_np, Lp = _rsc_encode_blocks(rsc, L)
    nb, Kb, _ = Td_np.shape
    U = jnp.pad(bits, ((0, 0), (0, Lp - L))).astype(jnp.int8)
    U = U.reshape(B, nb, Kb)
    acc = jnp.zeros((B, nb, Kb), jnp.int32)
    for d in range(nb):
        # parity block j receives u block j-d through Toeplitz block d
        part = jax.lax.dot_general(
            U[:, :nb - d], jnp.asarray(Td_np[d]),
            (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32)
        acc = acc.at[:, d:].add(part)
    z = (acc & 1).astype(jnp.uint8).reshape(B, Lp)[:, :L]

    # termination: final-state bit i = w_{L-S+i} = u . h-column i.
    st_acc = jax.lax.dot_general(
        bits.astype(jnp.int8), jnp.asarray(Tt_np),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32) & 1
    s = jnp.zeros((B,), jnp.int32)
    for i in range(S):
        s = s | (st_acc[:, i] << i)
    fb = rsc.g_fb & ((1 << S) - 1)
    fw_low = rsc.g_fw & ((1 << S) - 1)     # tail steps force w = 0
    st, pt = [], []
    for _ in range(S):
        st.append(_parity_bits(s, fb))
        pt.append(_parity_bits(s, fw_low))
        s = s >> 1
    return (bits, z,
            jnp.stack(st, axis=1).astype(jnp.uint8),
            jnp.stack(pt, axis=1).astype(jnp.uint8))


@functools.partial(jax.jit, static_argnums=(0,))
def turbo_encode_batch(rsc: RscSpec, bits, perm):
    """Jitted batched turbo encode: [B, L] bits -> dict of jnp streams
    (same keys/shapes as `turbo_encode_batch_np`, the oracle)."""
    bits = jnp.asarray(bits, jnp.uint8)
    sys_, par1, st1, pt1 = rsc_encode_batch(rsc, bits)
    perm = jnp.asarray(perm, jnp.int32)
    _, par2, st2, pt2 = rsc_encode_batch(rsc, jnp.take(bits, perm, axis=1))
    return {"sys": sys_, "par1": par1, "par2": par2,
            "sys_tail1": st1, "par_tail1": pt1,
            "sys_tail2": st2, "par_tail2": pt2}


# ---------------------------------------------------------------------------
# QPP interleaver (36.212 §5.1.3.2.3): pi(i) = (f1*i + f2*i^2) mod L.

#: 36.212 Table 5.1.3-3: turbo code internal interleaver parameters,
#: block length K -> (f1, f2) with pi(i) = (f1*i + f2*i^2) mod K.
QPP_TABLE = {
    40: (3, 10), 48: (7, 12), 56: (19, 42), 64: (7, 16),
    72: (7, 18), 80: (11, 20), 88: (5, 22), 96: (11, 24),
    104: (7, 26), 112: (41, 84), 120: (103, 90), 128: (15, 32),
    136: (9, 34), 144: (17, 108), 152: (9, 38), 160: (21, 120),
    168: (101, 84), 176: (21, 44), 184: (57, 46), 192: (23, 48),
    200: (13, 50), 208: (27, 52), 216: (11, 36), 224: (27, 56),
    232: (85, 58), 240: (29, 60), 248: (33, 62), 256: (15, 32),
    264: (17, 198), 272: (33, 68), 280: (103, 210), 288: (19, 36),
    296: (19, 74), 304: (37, 76), 312: (19, 78), 320: (21, 120),
    328: (21, 82), 336: (115, 84), 344: (193, 86), 352: (21, 44),
    360: (133, 90), 368: (81, 46), 376: (45, 94), 384: (23, 48),
    392: (243, 98), 400: (151, 40), 408: (155, 102), 416: (25, 52),
    424: (51, 106), 432: (47, 72), 440: (91, 110), 448: (29, 168),
    456: (29, 114), 464: (247, 58), 472: (29, 118), 480: (89, 180),
    488: (91, 122), 496: (157, 62), 504: (55, 84), 512: (31, 64),
    528: (17, 66), 544: (35, 68), 560: (227, 420), 576: (65, 96),
    592: (19, 74), 608: (37, 76), 624: (41, 234), 640: (39, 80),
    656: (185, 82), 672: (43, 252), 688: (21, 86), 704: (155, 44),
    720: (79, 120), 736: (139, 92), 752: (23, 94), 768: (217, 48),
    784: (25, 98), 800: (17, 80), 816: (127, 102), 832: (25, 52),
    848: (239, 106), 864: (17, 48), 880: (137, 110), 896: (215, 112),
    912: (29, 114), 928: (15, 58), 944: (147, 118), 960: (29, 60),
    976: (59, 122), 992: (65, 124), 1008: (55, 84), 1024: (31, 64),
    1056: (17, 66), 1088: (171, 204), 1120: (67, 140), 1152: (35, 72),
    1184: (19, 74), 1216: (39, 76), 1248: (19, 78), 1280: (199, 240),
    1312: (21, 82), 1344: (211, 252), 1376: (21, 86), 1408: (43, 88),
    1440: (149, 60), 1472: (45, 92), 1504: (49, 846), 1536: (71, 48),
    1568: (13, 28), 1600: (17, 80), 1632: (25, 102), 1664: (183, 104),
    1696: (55, 954), 1728: (127, 96), 1760: (27, 110), 1792: (29, 112),
    1824: (29, 114), 1856: (57, 116), 1888: (45, 354), 1920: (31, 120),
    1952: (59, 610), 1984: (185, 124), 2016: (113, 420), 2048: (31, 64),
    2112: (17, 66), 2176: (171, 136), 2240: (209, 420), 2304: (253, 216),
    2368: (367, 444), 2432: (265, 456), 2496: (181, 468), 2560: (39, 80),
    2624: (27, 164), 2688: (127, 504), 2752: (143, 172), 2816: (43, 88),
    2880: (29, 300), 2944: (45, 92), 3008: (157, 188), 3072: (47, 96),
    3136: (13, 28), 3200: (111, 240), 3264: (443, 204), 3328: (51, 104),
    3392: (51, 212), 3456: (451, 192), 3520: (257, 220), 3584: (57, 336),
    3648: (313, 228), 3712: (271, 232), 3776: (179, 236), 3840: (331, 120),
    3904: (363, 244), 3968: (375, 248), 4032: (127, 168), 4096: (31, 64),
    4160: (33, 130), 4224: (43, 264), 4288: (33, 134), 4352: (477, 408),
    4416: (35, 138), 4480: (233, 280), 4544: (357, 142), 4608: (337, 480),
    4672: (37, 146), 4736: (71, 444), 4800: (71, 120), 4864: (37, 152),
    4928: (39, 462), 4992: (127, 234), 5056: (39, 158), 5120: (39, 80),
    5184: (31, 96), 5248: (113, 902), 5312: (41, 166), 5376: (251, 336),
    5440: (43, 170), 5504: (21, 86), 5568: (43, 174), 5632: (45, 176),
    5696: (45, 178), 5760: (161, 120), 5824: (89, 182), 5888: (323, 184),
    5952: (47, 186), 6016: (23, 94), 6080: (47, 190), 6144: (263, 480),
}


def qpp_interleaver(L: int, f1: int | None = None,
                    f2: int | None = None) -> np.ndarray:
    """QPP permutation pi with pi[i] = (f1*i + f2*i^2) mod L.

    Defaults to `QPP_TABLE[L]` (the full 36.212 Table 5.1.3-3 — the
    single source of QPP parameters; `ops.lte` re-exports it).
    Validates the result is a permutation (QPP is bijective iff the
    standard's divisibility conditions on f1, f2 hold)."""
    if f1 is None or f2 is None:
        if L not in QPP_TABLE:
            raise ValueError(
                f"L={L} is not an LTE turbo block size; pass f1, f2")
        f1, f2 = QPP_TABLE[L]
    i = np.arange(L, dtype=np.int64)
    pi = ((f1 * i + f2 * i * i) % L).astype(np.int32)
    if np.unique(pi).size != L:
        raise ValueError(f"(f1={f1}, f2={f2}) is not a QPP for L={L}")
    return pi


# ---------------------------------------------------------------------------
# Encoding

def turbo_encode_np(rsc: RscSpec, bits: np.ndarray, perm: np.ndarray):
    """LTE turbo encode of one block (NumPy oracle-grade).

    Returns a dict of streams: systematic `sys` [L], parities `par1`,
    `par2` [L], and the two constituents' termination fields
    (`sys_tail1`, `par_tail1`, `sys_tail2`, `par_tail2`, each [S]) —
    the 12 tail bits for the LTE constituent.  Rate = L / (3L + 4S).
    """
    bits = np.asarray(bits, np.uint8)
    sys_, par1, st1, pt1 = rsc_encode_np(rsc, bits)
    _, par2, st2, pt2 = rsc_encode_np(rsc, bits[np.asarray(perm)])
    return {"sys": sys_, "par1": par1, "par2": par2,
            "sys_tail1": st1, "par_tail1": pt1,
            "sys_tail2": st2, "par_tail2": pt2}


# ---------------------------------------------------------------------------
# Constituent max-log-MAP with a-priori input

@functools.partial(jax.jit, static_argnums=(0,))
def rsc_maxlogmap(rsc: RscSpec, l_sys, l_par, l_apriori,
                  l_sys_tail, l_par_tail):
    """A-posteriori LLRs of one RSC block via max-log-MAP.

    All inputs are integer quantized LLRs (positive favors bit 0):
      l_sys, l_par, l_apriori: [L] message-step channel/a-priori LLRs.
      l_sys_tail, l_par_tail: [S] termination-step channel LLRs.

    Returns int32 [L] full a-posteriori LLRs of the message bits.
    Extrinsic for the turbo exchange = Lapp - l_sys - l_apriori.

    The backward pass is anchored at state 0 through the S tail steps;
    the tail input is trellis-forced, so leaving u free under the
    anchor admits exactly the termination path per start state (the
    trellis is 2-regular and the zero-feedback path is unique).
    """
    NS = rsc.num_states
    nxt, par, prev, pu = (jnp.asarray(t) for t in rsc_tables(rsc))
    l_sys = jnp.asarray(l_sys, jnp.int32)
    l_par = jnp.asarray(l_par, jnp.int32)
    l_apriori = jnp.asarray(l_apriori, jnp.int32)
    l_u = l_sys + l_apriori
    L = l_sys.shape[0]

    # Branch cost per (t, u, s): u*(l_u) + parity(u,s)*l_par; tail steps
    # carry channel terms only (no a-priori on forced inputs).
    lu_all = jnp.concatenate([l_u, jnp.asarray(l_sys_tail, jnp.int32)])
    lp_all = jnp.concatenate([l_par, jnp.asarray(l_par_tail, jnp.int32)])
    u_arr = jnp.arange(2, dtype=jnp.int32)[:, None]          # [2, 1]
    bm = (u_arr[None] * lu_all[:, None, None]
          + par[None] * lp_all[:, None, None])               # [L+S, 2, NS]

    big = jnp.asarray(BIG, jnp.int32)
    a0 = jnp.full((NS,), big, jnp.int32).at[0].set(0)

    def fstep(m, bm_t):
        # alpha_{t+1}(d) = min_e alpha_t(prev[e,d]) + bm_t(pu[e,d], prev)
        cand = m[prev] + bm_t[pu, prev]                       # [2, NS]
        return jnp.min(cand, axis=0), m

    _, alphas = jax.lax.scan(fstep, a0, bm)                   # alpha_t

    bT = jnp.full((NS,), big, jnp.int32).at[0].set(0)

    def bstep(b, bm_t):
        cand = bm_t + b[nxt]                                  # [2(u), NS(s)]
        return jnp.min(cand, axis=0), cand

    _, cands = jax.lax.scan(bstep, bT, bm, reverse=True)
    tot = alphas[:, None, :] + cands                          # [L+S, 2, NS]
    per_u = jnp.min(tot[:L], axis=2)                          # [L, 2]
    return (per_u[:, 1] - per_u[:, 0]).astype(jnp.int32)


def _turbo_iteration(rsc: RscSpec, l_sys, l_par1, l_par2, l_sys_tail1,
                     l_par_tail1, l_sys_tail2, l_par_tail2, perm: tuple):
    """One full batched turbo iteration (DEC1 -> interleave -> DEC2 ->
    de-interleave), shared by the fixed-count and early-terminating
    decoders so their exchange schedule cannot drift apart.

    Returns `one_iter(la1) -> (la1_next, lapp)`, `lapp` the
    de-interleaved DEC2 a-posteriori LLRs, all [B, L] int32."""
    pi = np.asarray(perm, np.int32)
    inv = np.argsort(pi).astype(np.int32)
    mapb = jax.vmap(functools.partial(rsc_maxlogmap, rsc))
    l_sys = jnp.asarray(l_sys, jnp.int32)
    l_sys_i = l_sys[:, pi]

    def one_iter(la1):
        lapp1 = mapb(l_sys, l_par1, la1, l_sys_tail1, l_par_tail1)
        le1 = lapp1 - l_sys - la1
        la2 = jnp.clip((3 * le1[:, pi]) // 4, -LA_CLAMP, LA_CLAMP)
        lapp2 = mapb(l_sys_i, l_par2, la2, l_sys_tail2, l_par_tail2)
        le2 = lapp2 - l_sys_i - la2
        la1n = jnp.clip((3 * le2) // 4, -LA_CLAMP, LA_CLAMP)[:, inv]
        return la1n, lapp2[:, inv]

    return one_iter


def turbo_decode_batch(rsc: RscSpec, l_sys, l_par1, l_par2,
                       l_sys_tail1, l_par_tail1, l_sys_tail2, l_par_tail2,
                       perm, n_iters: int = 6):
    """Iterative turbo decode of a batch of blocks (max-log-MAP exchange).

    Args:
      l_sys/l_par1/l_par2: [B, L] integer channel LLRs of the systematic
        and the two parity streams (positive favors 0; punctured or
        un-transmitted positions are 0 — e.g. rate matching).
      l_*_tail1/2: [B, S] LLRs of each constituent's 12-tail-bit field.
      perm: the interleaver (array or sequence), e.g.
        `qpp_interleaver(L)`.
      n_iters: full DEC1->DEC2 exchanges (unrolled at trace time).

    Returns (uint8 [B, L] decoded bits, int32 [B, L] final a-posteriori
    LLRs).

    Max-log extrinsic is scaled by 3/4 (integer >> with rounding) —
    the standard correction for the max-log approximation's
    overconfidence — and the exchanged a-priori is clamped to
    +/- `LA_CLAMP` (part of the algorithm, implemented identically by
    the C++ oracle; see the `LA_CLAMP` note).
    """
    return _turbo_decode_batch(
        rsc, l_sys, l_par1, l_par2, l_sys_tail1, l_par_tail1, l_sys_tail2,
        l_par_tail2, tuple(int(p) for p in np.asarray(perm)), n_iters)


@functools.partial(jax.jit, static_argnums=(0, 8, 9))
def _turbo_decode_batch(rsc: RscSpec, l_sys, l_par1, l_par2,
                        l_sys_tail1, l_par_tail1, l_sys_tail2, l_par_tail2,
                        perm: tuple, n_iters: int):
    one_iter = _turbo_iteration(rsc, l_sys, l_par1, l_par2, l_sys_tail1,
                                l_par_tail1, l_sys_tail2, l_par_tail2, perm)
    la1 = jnp.zeros(jnp.shape(l_sys), jnp.int32)
    lapp = jnp.zeros(jnp.shape(l_sys), jnp.int32)
    for _ in range(n_iters):
        la1, lapp = one_iter(la1)
    return (lapp < 0).astype(jnp.uint8), lapp


def turbo_decode(rsc: RscSpec, l_sys, l_par1, l_par2,
                 l_sys_tail1, l_par_tail1, l_sys_tail2, l_par_tail2,
                 perm: tuple, n_iters: int = 6):
    """`turbo_decode_batch` of one block ([L] and [S] fields).  Returns
    (uint8 [L] decoded bits, int32 [L] a-posteriori LLRs)."""
    fields = (l_sys, l_par1, l_par2, l_sys_tail1, l_par_tail1,
              l_sys_tail2, l_par_tail2)
    bits, lapp = turbo_decode_batch(
        rsc, *(jnp.asarray(f)[None] for f in fields), perm, n_iters)
    return bits[0], lapp[0]


@functools.partial(jax.jit, static_argnums=(0, 8, 9, 10))
def turbo_decode_batch_early(rsc: RscSpec, l_sys, l_par1, l_par2,
                             l_sys_tail1, l_par_tail1,
                             l_sys_tail2, l_par_tail2,
                             perm: tuple, crc, max_iters: int = 8):
    """Batched turbo decode with CRC-gated early termination.

    After every full iteration the whole batch's CRCs are checked (one
    bit-matmul, `ops.crc`); blocks latch their first CRC-passing
    decisions, and the `lax.while_loop` exits as soon as EVERY block has
    passed (or at `max_iters`).  Latching means a block that ever
    passes is never degraded by later iterations.

    `crc` is a `CrcSpec` whose parity the encoded payload carries (e.g.
    `CRC24B` per 36.212 code block).  Returns (bits [B, L], lapp [B, L],
    ok [B] bool, iters_used int32).  A block with ok=False decodes as
    `turbo_decode_batch` after `iters_used` iterations.
    """
    from .crc import crc_check
    if crc is None:
        raise ValueError("early termination needs a CrcSpec (pass "
                         "crc=CRC24B or use turbo_decode_batch)")
    one_iter = _turbo_iteration(rsc, l_sys, l_par1, l_par2, l_sys_tail1,
                                l_par_tail1, l_sys_tail2, l_par_tail2, perm)
    B, L = jnp.shape(l_sys)

    def cond(carry):
        it, _, _, ok, _, _ = carry
        return (it < max_iters) & ~jnp.all(ok)

    def body(carry):
        it, la1, _, ok, best_bits, best_lapp = carry
        la1n, lapp = one_iter(la1)
        bits = (lapp < 0).astype(jnp.uint8)
        okb = crc_check(crc, bits)
        newly = okb & ~ok
        best_bits = jnp.where(newly[:, None], bits, best_bits)
        best_lapp = jnp.where(newly[:, None], lapp, best_lapp)
        return (it + 1, la1n, lapp, ok | okb, best_bits, best_lapp)

    init = (jnp.int32(0), jnp.zeros((B, L), jnp.int32),
            jnp.zeros((B, L), jnp.int32), jnp.zeros((B,), bool),
            jnp.zeros((B, L), jnp.uint8), jnp.zeros((B, L), jnp.int32))
    it, _, lapp, ok, best_bits, best_lapp = jax.lax.while_loop(
        cond, body, init)
    bits = jnp.where(ok[:, None], best_bits, (lapp < 0).astype(jnp.uint8))
    lapp = jnp.where(ok[:, None], best_lapp, lapp)
    return bits, lapp, ok, it
