"""3GPP LTE rate matching for tail-biting convolutionally coded channels.

Implements 36.212 §5.1.4.2 — the standard's mechanism for fitting a
rate-1/3 TBCC codeword (PBCH / PDCCH DCI) to an arbitrary number of
channel bits E: each of the n coded streams passes through a 32-column
sub-block interleaver (with NULL front-padding), the interleaved
streams are concatenated into a circular buffer, and E bits are read
from it — puncturing when E < n*D, REPEATING when E > n*D.  The
receiver inverts this with soft combining: repeated transmissions of
the same coded bit ADD their LLRs, punctured bits become zero-LLR
erasures.

Not present in the reference (its scope stops at the codec itself,
`src/convEncode.c`, `viterbiDecoder.c`); this
completes the production receive chain the CRC-list decoder
(`ops/tailbiting.py`) serves, replacing the generic
`ops.puncture` patterns with the actual standard mapping.

Static design: for a fixed (n, D, E) the entire standard procedure
collapses to a STATIC index map computed in NumPy at trace time.
Rate matching is then ONE gather (`jnp.take`) and de-rate-matching is
ONE scatter-add (`.at[idx].add`) — which implements repetition soft
combining for free, since every transmitted copy of coded bit j lands
on accumulator slot j.  Both fuse into the one-jit receiver; there is
no per-bit control flow anywhere.

Conventions: coded bits/LLRs are step-major (trellis step t, generator
j at position t*n + j), matching `ops.channel.segments_to_bits` and the
puncture module.  Generator j is stream d^(j) of the standard.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec

#: 36.212 Table 5.1.4-2: inter-column permutation pattern for the
#: convolutional-code sub-block interleaver (C = 32 columns).
SUBBLOCK_PERM = (
    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
    0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
)

NCOLS = 32


@functools.lru_cache(maxsize=None)
def subblock_interleave_map(D: int) -> np.ndarray:
    """Sub-block interleaver of one length-D stream, as an index map.

    Per 36.212 §5.1.4.2.1: prepend ND = R*32 - D NULLs, write the
    padded stream row-by-row into an R x 32 matrix, permute the columns
    by `SUBBLOCK_PERM`, read out column-by-column.

    Returns int32 [R*32]: entry p is the source index (into the
    unpadded stream, 0..D-1) of interleaved position p, or -1 where the
    position holds a NULL padding bit.
    """
    if D <= 0:
        raise ValueError("stream length D must be positive")
    R = -(-D // NCOLS)
    ND = R * NCOLS - D
    # Padded row-major matrix position (r, c) holds source bit r*32+c-ND
    # (negative = NULL).  Reading permuted column j top-to-bottom places
    # matrix position (r, PERM[j]) at output index j*R + r.
    r = np.arange(R)
    out = np.empty(R * NCOLS, dtype=np.int32)
    for j, c in enumerate(SUBBLOCK_PERM):
        out[j * R:(j + 1) * R] = r * NCOLS + c - ND
    out[out < 0] = -1
    return out


@functools.lru_cache(maxsize=None)
def circular_buffer_map(n: int, D: int) -> np.ndarray:
    """The non-NULL circular buffer as step-major source indices.

    Per §5.1.4.2.2 the buffer w is the concatenation of the n
    interleaved streams v^(0)..v^(n-1); bit selection (§5.1.4.2.3)
    skips NULLs, so the effective cycle is w with NULLs removed —
    length exactly n*D, a permutation of the codeword.

    Returns int32 [n*D]: entry m is the step-major codeword position
    (t*n + j) transmitted m-th within one full buffer cycle.
    """
    v = subblock_interleave_map(D)
    streams = []
    for j in range(n):
        s = v.copy()
        live = s >= 0
        s[live] = s[live] * n + j  # stream j's bit t sits at t*n + j
        streams.append(s)
    w = np.concatenate(streams)
    return w[w >= 0].astype(np.int32)


@functools.lru_cache(maxsize=None)
def ratematch_indices(n: int, D: int, E: int) -> np.ndarray:
    """Source index (step-major, 0..n*D-1) of each of the E output bits."""
    if E <= 0:
        raise ValueError("output length E must be positive")
    wnn = circular_buffer_map(n, D)
    return wnn[np.arange(E) % wnn.size].astype(np.int32)


def rate_match(coded, spec: CodeSpec, D: int, E: int):
    """Select E channel bits (or LLR-domain values) from a codeword.

    Args:
      coded: [..., D*n] step-major coded bits / values.
      D: trellis steps in the codeword (message bits for k=1 TBCC).
      E: number of channel bits to transmit.
    Returns:
      [..., E] the transmitted sequence, in transmission order.
    """
    idx = jnp.asarray(ratematch_indices(spec.n, D, E))
    return jnp.take(jnp.asarray(coded), idx, axis=-1)


def rate_match_segments(segments, spec: CodeSpec, E: int):
    """`rate_match` taking [..., D, n] segment-form codewords."""
    seg = jnp.asarray(segments)
    D = seg.shape[-2]
    return rate_match(seg.reshape(seg.shape[:-2] + (D * spec.n,)),
                      spec, D, E)


def derate_match(llrs, spec: CodeSpec, D: int, qmax: int | None = None):
    """Invert rate matching with repetition soft combining.

    Scatter-adds the E received LLRs onto their n*D codeword slots:
    coded bits transmitted multiple times (E > n*D) accumulate — chase
    combining exactly as the standard intends — and bits never
    transmitted (E < n*D) stay 0, the soft kernels' free erasure.

    To combine several transmissions of the SAME codeword (PBCH
    re-reads, DCI aggregation-level retries), sum the per-transmission
    outputs before clipping: `derate_match(a,...) + derate_match(b,...)`.

    Args:
      llrs: [..., E] received LLRs in transmission order (int or float).
      qmax: if given, clip to [-qmax, qmax] and cast to int8 — ready
        for the quantized soft kernels.  Default returns the unclipped
        int32/float accumulator.
    Returns:
      [..., D, n] segment-form LLRs of the full codeword.
    """
    llrs = jnp.asarray(llrs)
    E = llrs.shape[-1]
    idx = jnp.asarray(ratematch_indices(spec.n, D, E))
    acc_dtype = llrs.dtype if jnp.issubdtype(llrs.dtype, jnp.floating) \
        else jnp.int32
    out = jnp.zeros(llrs.shape[:-1] + (D * spec.n,), acc_dtype)
    out = out.at[..., idx].add(llrs.astype(acc_dtype))
    if qmax is not None:
        out = jnp.clip(out, -qmax, qmax).astype(jnp.int8)
    return out.reshape(llrs.shape[:-1] + (D, spec.n))
