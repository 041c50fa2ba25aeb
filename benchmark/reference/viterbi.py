"""Plain Viterbi decoding of rate-1/n convolutional codes, in `jax.numpy`.

Written from the code's definition and the reference C decoder's
conventions, with nothing of the program: no kernel, no butterfly, no
packed decisions.  It runs on the device in blocks of rows.

Conventions (viterbiDecoder.c): the state is the last K - 1 input bits,
the newest at bit 0, so input u moves state s to ((s << 1) | u) mod 2^(K-1);
destination d is reached from d >> 1 (decision 0) and (d >> 1) + 2^(K-2)
(decision 1); a tie keeps decision 0; the decoded bit of step t is bit 0
of the state after step t.  A packet starts in state 0, every other state
at 2^(K-1) + 1 (the reference's forceNot).  Branch costs: Hamming distance
for hard n-bit segments; for soft LLRs q (positive favours 0) a coded 0
costs max(-q, 0) and a coded 1 costs max(q, 0).

Two ways to read the decisions out, one per kind of traffic:

* `block_decode`: the whole terminated packet, walked back from state 0.
* `stream_decode`: chunked decoding with carried metrics; after each
  chunk, every bit older than `lookahead` steps is walked back from the
  best state (lowest index on ties), and the last chunk walks from state 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _parity(x: np.ndarray) -> np.ndarray:
    return np.array([bin(int(v)).count("1") & 1 for v in x.ravel()],
                    np.int32).reshape(x.shape)


def edge_tables(K: int, gens) -> tuple:
    """For every destination d and decision e: the source state and the
    coded segment of that edge.  Returns (src [2, NS], seg [2, NS])."""
    NS = 1 << (K - 1)
    d = np.arange(NS)
    src = np.stack([d >> 1, (d >> 1) + NS // 2])
    u = d & 1
    seg = np.zeros((2, NS), np.int32)
    for e in range(2):
        delay = (src[e] << 1) | u                     # K bits, newest at 0
        for j, g in enumerate(gens):
            rev = int(format(int(g), f"0{K}b")[::-1], 2)   # newest tap at 0
            seg[e] |= _parity(delay & rev) << j
    return src.astype(np.int32), seg


def start_metrics(rows: int, K: int):
    NS = 1 << (K - 1)
    m = np.full((NS,), NS + 1, np.int32)
    m[0] = 0
    return jnp.broadcast_to(jnp.asarray(m), (rows, NS))


def _branch_costs(x_t, seg, n: int, soft: bool):
    """[rows, NS] cost of the edge with coded segments `seg` [NS]."""
    if soft:
        cost = 0
        for j in range(n):
            q = x_t[:, j:j + 1].astype(jnp.int32)
            bit = (seg[None, :] >> j) & 1
            cost = cost + jnp.where(bit == 1, jnp.maximum(q, 0),
                                    jnp.maximum(-q, 0))
        return cost
    diff = x_t[:, None].astype(jnp.int32) ^ seg[None, :]
    return sum((diff >> j) & 1 for j in range(n))


@functools.partial(jax.jit, static_argnames=("K", "gens"))
def forward(x, m0, *, K: int, gens: tuple):
    """Add-compare-select over hard uint8 [rows, T] segments or soft
    [rows, T, n] LLRs from metrics m0 [rows, NS].

    Returns (decisions uint8 [T, rows, NS], best state after each step
    int32 [T, rows], final metrics [rows, NS])."""
    src, seg = (jnp.asarray(a) for a in edge_tables(K, gens))
    soft = x.ndim == 3
    n = len(gens)
    xs = jnp.moveaxis(x, 1, 0)

    def step(m, x_t):
        p0 = m[:, src[0]] + _branch_costs(x_t, seg[0], n, soft)
        p1 = m[:, src[1]] + _branch_costs(x_t, seg[1], n, soft)
        dec = p1 < p0
        m = jnp.where(dec, p1, p0)
        return m, (dec.astype(jnp.uint8), jnp.argmin(m, axis=1).astype(jnp.int32))

    m, (dec, best) = jax.lax.scan(step, jnp.asarray(m0, jnp.int32), xs)
    return dec, best, m


@functools.partial(jax.jit, static_argnames=("K", "length"))
def walk(dec, row, start, t_last, *, K: int, length: int):
    """Walk back `length` steps from state `start` after step `t_last` of
    row `row` of `dec`, one walk per entry.  Returns uint8 [walks, length]
    decoded bits in time order: column i is step t_last - length + 1 + i
    (steps before 0 read step 0 and are junk)."""
    T = dec.shape[0]

    def step(s, i):
        t = jnp.clip(t_last - i, 0, T - 1)
        e = dec[t, row, s].astype(jnp.int32)
        return (s >> 1) | (e << (K - 2)), (s & 1).astype(jnp.uint8)

    _, bits = jax.lax.scan(step, jnp.asarray(start, jnp.int32),
                           jnp.arange(length))
    return bits[::-1].T


def block_decode(x, K: int, gens: tuple, message_bits: int):
    """Terminated packets -> uint8 [rows, message_bits] decoded bits."""
    rows, T = x.shape[:2]
    dec, _, _ = forward(x, start_metrics(rows, K), K=K, gens=gens)
    r = jnp.arange(rows, dtype=jnp.int32)
    bits = walk(dec, r, jnp.zeros((rows,), jnp.int32),
                jnp.full((rows,), T - 1, jnp.int32), K=K, length=T)
    return bits[:, :message_bits]


def chunk_ends(T: int, chunk: int) -> list:
    return list(range(chunk, T, chunk)) + [T]


def stream_decode(x, K: int, gens: tuple, chunk: int, lookahead: int):
    """Terminated streams fed as chunks of `chunk` steps (the last holds
    the remainder) -> uint8 [rows, T - K + 1] bits, the emissions of all
    chunks in order."""
    rows, T = x.shape[:2]
    S = K - 1
    dec, best, _ = forward(x, start_metrics(rows, K), K=K, gens=gens)
    walks, done = [], 0                    # (t_last, length, first, count)
    ends = chunk_ends(T, chunk)
    for i, end in enumerate(ends):
        last = i == len(ends) - 1
        upto = end - S if last else end - lookahead
        if upto > done:
            walks.append((end - 1, end - done, upto - done, last))
            done = upto
    length = max(w[1] for w in walks)
    r = jnp.arange(rows, dtype=jnp.int32)
    out = []
    for t_last, span, count, last in walks:
        start = (jnp.zeros((rows,), jnp.int32) if last else best[t_last])
        bits = walk(dec, r, start, jnp.full((rows,), t_last, jnp.int32),
                    K=K, length=length)
        out.append(bits[:, length - span:length - span + count])
    return jnp.concatenate(out, axis=1)


def depuncture(q, pattern, T: int):
    """int8 [rows, kept] LLRs in transmission order -> [rows, T, n] with
    zero (an erasure) at every punctured position."""
    pat = np.asarray(pattern, bool)
    n, period = pat.shape
    mask = np.tile(pat.T, (-(-T // period), 1))[:T]          # [T, n]
    flat = jnp.zeros((q.shape[0], T * n), q.dtype)
    flat = flat.at[:, np.nonzero(mask.reshape(-1))[0]].set(q)
    return flat.reshape(q.shape[0], T, n)


def pack_bits(bits):
    """uint8 [rows, L] bits -> [rows, ceil(L / 8)] bytes, MSb first."""
    L = bits.shape[1]
    bits = jnp.pad(bits, ((0, 0), (0, (-L) % 8)))
    w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    return jnp.sum(bits.reshape(bits.shape[0], -1, 8) * w, axis=2,
                   dtype=jnp.uint8)
