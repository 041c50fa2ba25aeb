"""LTE transport-channel processing for turbo-coded channels (36.212 §5.1).

Completes the production chain around `ops.turbo` the same way
`ops.ratematch` completes it around the tail-biting convolutional
decoder: code-block segmentation (§5.1.2, CRC24B per block, filler
bits), the turbo internal interleaver parameter table (§5.1.3.2.3,
Table 5.1.3-3 — all 188 block sizes), trellis-termination bit
multiplexing (§5.1.3.2.2), and turbo rate matching (§5.1.4.1: three
sub-block interleavers, systematic-first bit collection with the two
parity streams interlaced, circular-buffer bit selection with
redundancy versions and a soft-buffer limit).

Beyond-reference territory (the reference stops at the convolutional
codec, `src/convEncode.c`, `viterbiDecoder.c`), but the
design rules are the framework's own: every standard procedure that
permutes or selects bits collapses to a STATIC NumPy index map at
trace time, so the device program sees one gather on transmit and one
scatter-add on receive (repetition chase-combines for free; punctured
positions stay at the soft decoders' zero-LLR erasure; filler bits are
known zeros and re-enter the decoder as strong LLRs).

Transcription note: `QPP_TABLE` (defined in `ops.turbo`, re-exported
here) is 36.212 Table 5.1.3-3 carried as golden data.  Every entry is validated to define a bijection the first
time it is used (`turbo.qpp_interleaver` raises otherwise), and the
chain is self-consistent end-to-end by construction — transmitter and
receiver derive both directions from the same map.
"""

from __future__ import annotations

import bisect
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import turbo as turbo_mod
from .turbo import QPP_TABLE, RscSpec, qpp_interleaver


#: Valid turbo code block sizes, ascending.
LTE_BLOCK_SIZES = tuple(sorted(QPP_TABLE))

#: LTE max code block size (36.212 §5.1.2).
Z_MAX = 6144

#: 36.212 Table 5.1.4-1: inter-column permutation for the TURBO
#: sub-block interleaver (differs from the convolutional Table 5.1.4-2
#: in `ops.ratematch.SUBBLOCK_PERM`).
TURBO_SUBBLOCK_PERM = (
    0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
)

NCOLS = 32


@functools.lru_cache(maxsize=None)
def _lte_qpp_cached(L: int) -> np.ndarray:
    if L not in QPP_TABLE:
        raise ValueError(f"L={L} is not an LTE turbo block size")
    return qpp_interleaver(L)


def lte_qpp(L: int) -> np.ndarray:
    """The standard interleaver for block size L (must be in the table).
    Returns a fresh copy — caller mutation must not corrupt the cache."""
    return _lte_qpp_cached(L).copy()


# ---------------------------------------------------------------------------
# §5.1.3.2.2 — trellis termination: multiplex the 12 tail bits onto the
# three stream tails so every stream has length D = L + 4.

def turbo_mux_streams(enc: dict) -> np.ndarray:
    """Multiplex `turbo_encode_np`'s output dict into streams d [3, L+4].

    Per 36.212 §5.1.3.2.2: d0 = systematic, d1 = parity1, d2 = parity2
    for k < L; the 12 termination bits (x_K.., z_K.. of encoder 1 and
    x'_K.., z'_K.. of encoder 2) fill the last 4 positions of each
    stream in the standard's interlaced order.

    Accepts both one block ([L] streams, [3] tails) and a batch
    ([B, L] streams, [B, 3] tails) from `turbo_encode_batch_np`.
    """
    ns = jnp if isinstance(enc["sys"], jnp.ndarray) else np
    sys_, p1, p2 = (ns.asarray(enc[k]) for k in ("sys", "par1", "par2"))
    x, z = ns.asarray(enc["sys_tail1"]), ns.asarray(enc["par_tail1"])
    xp, zp = ns.asarray(enc["sys_tail2"]), ns.asarray(enc["par_tail2"])
    if x.shape[-1] != 3:
        raise ValueError("LTE termination multiplexing needs S=3 (8-state)")
    t = lambda *cols: ns.stack(cols, axis=-1)
    cat = lambda a, b: ns.concatenate([a, b], axis=-1)
    d0 = cat(sys_, t(x[..., 0], z[..., 1], xp[..., 0], zp[..., 1]))
    d1 = cat(p1, t(z[..., 0], x[..., 2], zp[..., 0], xp[..., 2]))
    d2 = cat(p2, t(x[..., 1], z[..., 2], xp[..., 1], zp[..., 2]))
    return ns.stack([d0, d1, d2], axis=-2).astype(sys_.dtype)


def turbo_demux_tails(d):
    """Invert `turbo_mux_streams` on (possibly soft) streams [..., 3, D].

    Returns the 8 per-constituent fields `turbo_decode` consumes:
    (l_sys, l_par1, l_par2, sys_tail1, par_tail1, sys_tail2, par_tail2),
    message fields [..., L] and tails [..., 3].
    """
    d0, d1, d2 = d[..., 0, :], d[..., 1, :], d[..., 2, :]
    L = d0.shape[-1] - 4
    stack = jnp.stack if isinstance(d, jnp.ndarray) else np.stack
    sys_tail1 = stack([d0[..., L], d2[..., L], d1[..., L + 1]], axis=-1)
    par_tail1 = stack([d1[..., L], d0[..., L + 1], d2[..., L + 1]], axis=-1)
    sys_tail2 = stack([d0[..., L + 2], d2[..., L + 2], d1[..., L + 3]],
                      axis=-1)
    par_tail2 = stack([d1[..., L + 2], d0[..., L + 3], d2[..., L + 3]],
                      axis=-1)
    return (d0[..., :L], d1[..., :L], d2[..., :L],
            sys_tail1, par_tail1, sys_tail2, par_tail2)


# ---------------------------------------------------------------------------
# §5.1.4.1 — turbo rate matching as a static index map.

@functools.lru_cache(maxsize=None)
def _turbo_w_map(D: int, F: int) -> np.ndarray:
    """The turbo circular buffer w as flat source indices.

    Returns int32 [Kw = 3*R*32]: entry p is the flat source index
    (stream*D + k, stream-major) feeding circular-buffer position p, or
    -1 where the position holds a <NULL> (sub-block padding, or one of
    the F filler-bit positions of streams 0 and 1, which §5.1.2 sets to
    <NULL> and bit selection skips).

    Layout per §5.1.4.1.2: v0 (interleaved d0) first, then v1 and v2
    interlaced bit-by-bit.  v0/v1 use the Table 5.1.4-1 column
    permutation; v2 uses the shifted map pi(k) = (P[k/R] + 32*(k%R)
    + 1) mod KP (§5.1.4.1.1).
    """
    R = -(-D // NCOLS)
    KP = R * NCOLS
    ND = KP - D

    # Streams 0/1: write row-major with ND leading NULLs, read permuted
    # columns.  Output index j*R + r holds padded position r*32+P[j].
    v01 = np.empty(KP, np.int32)
    r = np.arange(R)
    for j, c in enumerate(TURBO_SUBBLOCK_PERM):
        v01[j * R:(j + 1) * R] = r * NCOLS + c - ND
    v01[v01 < 0] = -1
    # Filler positions (source bit index < F) are NULL in streams 0/1.
    v01_f = v01.copy()
    v01_f[(v01_f >= 0) & (v01_f < F)] = -1

    # Stream 2: pi(k) addresses the same padded row-major buffer.
    k = np.arange(KP)
    perm = np.asarray(TURBO_SUBBLOCK_PERM, np.int64)
    pi = (perm[k // R] + NCOLS * (k % R) + 1) % KP
    v2 = (pi - ND).astype(np.int32)
    v2[v2 < 0] = -1

    def tag(v, stream):
        out = v.copy()
        out[out >= 0] += stream * D
        return out

    w = np.empty(3 * KP, np.int32)
    w[:KP] = tag(v01_f, 0)
    w[KP::2] = tag(v01_f, 1)
    w[KP + 1::2] = tag(v2, 2)
    return w


@functools.lru_cache(maxsize=None)
def _turbo_ratematch_indices_cached(D: int, E: int, rv: int,
                                    Ncb: int | None,
                                    F: int) -> np.ndarray:
    R = -(-D // NCOLS)
    KP = R * NCOLS
    Kw = 3 * KP
    Ncb = Kw if Ncb is None else min(Ncb, Kw)
    w = _turbo_w_map(D, F)[:Ncb]
    k0 = R * (2 * (-(-Ncb // (8 * R))) * rv + 2)
    order = (k0 + np.arange(Ncb)) % Ncb
    sel = w[order]
    sel = sel[sel >= 0]
    if sel.size == 0:
        raise ValueError("soft buffer holds no transmittable bits")
    reps = -(-E // sel.size)
    return np.tile(sel, reps)[:E].astype(np.int32)


def turbo_ratematch_indices(D: int, E: int, rv: int = 0,
                            Ncb: int | None = None,
                            F: int = 0) -> np.ndarray:
    """Bit-selection source indices for one turbo-coded block.

    Returns int32 [E]: flat source indices (stream*D + k) of the
    transmitted bits, in transmission order — the §5.1.4.1.2 loop
    (start at k0 = R*(2*ceil(Ncb/(8R))*rv + 2), wrap modulo Ncb, skip
    <NULL>s) evaluated once in NumPy.  Returns a fresh copy of the
    cached map so caller mutation cannot corrupt later rate matching.
    """
    return _turbo_ratematch_indices_cached(D, E, rv, Ncb, F).copy()


def rate_match_turbo(d, E: int, rv: int = 0, Ncb: int | None = None,
                     F: int = 0):
    """Rate-match turbo streams d [..., 3, D] to E bits: ONE gather."""
    D = d.shape[-1]
    idx = jnp.asarray(turbo_ratematch_indices(D, E, rv, Ncb, F))
    flat = jnp.reshape(jnp.asarray(d), d.shape[:-2] + (3 * D,))
    return jnp.take(flat, idx, axis=-1)


def derate_match_turbo(llrs, D: int, rv: int = 0, Ncb: int | None = None,
                       F: int = 0, qmax: int | None = None,
                       filler_llr: int = 0):
    """Invert `rate_match_turbo` on received LLRs [..., E] → [..., 3, D].

    Scatter-add: repeated transmissions of a coded bit chase-combine,
    punctured positions stay at the zero-LLR erasure.  Filler positions
    (known zeros) get `filler_llr` (pass a large positive value to give
    the decoder the known bits).  `qmax` clips the combined LLRs.
    """
    llrs = jnp.asarray(llrs, jnp.int32)
    E = llrs.shape[-1]
    idx = jnp.asarray(turbo_ratematch_indices(D, E, rv, Ncb, F))
    flat = jnp.zeros(llrs.shape[:-1] + (3 * D,), jnp.int32)
    flat = flat.at[..., idx].add(llrs)
    if qmax is not None:
        flat = jnp.clip(flat, -qmax, qmax)
    if F:
        fidx = jnp.arange(F)
        flat = flat.at[..., fidx].set(filler_llr)          # stream 0
        flat = flat.at[..., D + fidx].set(filler_llr)      # stream 1
    return jnp.reshape(flat, llrs.shape[:-1] + (3, D))


# ---------------------------------------------------------------------------
# §5.1.2 — code block segmentation.

def segment_sizes(B: int) -> tuple[int, int, int, int, int]:
    """Code-block segmentation arithmetic for a B-bit input.

    Returns (C, Kp, Km, Cp, Cm): C blocks total, Cp of size Kp and Cm
    of size Km (Kp > Km), plus F filler bits via
    `Cp*Kp + Cm*Km - B'`.  Matches 36.212 §5.1.2 exactly (B' includes
    the per-block CRC24B only when C > 1).
    """
    if B < 1:
        raise ValueError("B must be positive")
    if B <= Z_MAX:
        C, Bp = 1, B
    else:
        C = -(-B // (Z_MAX - 24))
        Bp = B + 24 * C
    sizes = LTE_BLOCK_SIZES
    kp_i = bisect.bisect_left(sizes, -(-Bp // C))
    if kp_i >= len(sizes):
        raise ValueError("block too large for the size table")
    Kp = sizes[kp_i]
    if C == 1:
        return 1, Kp, 0, 1, 0
    Km = sizes[kp_i - 1] if kp_i > 0 else 0
    if Km:
        dK = Kp - Km
        Cm = (C * Kp - Bp) // dK
    else:
        Cm = 0
    return C, Kp, Km, C - Cm, Cm


def _segment_layout(B: int) -> tuple[list[int], int]:
    """Per-code-block sizes (transmission order: the Cm smaller Km
    blocks first, per §5.1.2's k ordering) and filler count F for a
    B-bit segmentation input.  THE single source of the layout — both
    the encode side (`segment_tb`) and the decode side
    (`dlsch_block_sizes`) derive from it, so they cannot desync.
    """
    C, Kp, Km, Cp, Cm = segment_sizes(B)
    F = Cm * Km + Cp * Kp - (B + (24 * C if C > 1 else 0))
    return [Km] * Cm + [Kp] * Cp, F


def segment_tb(bits: np.ndarray):
    """Segment a transport block (TB CRC already attached) per §5.1.2.

    Returns (blocks, F): `blocks` a list of C uint8 arrays — each a
    complete code block (filler zeros prepended to the first, CRC24B
    appended to every block when C > 1) sized to the QPP table — and
    the filler count F (fillers occupy block 0's first F positions and
    are <NULL> for rate matching).
    """
    from .crc import CRC24B, crc_append
    bits = np.asarray(bits, np.uint8)
    B = bits.size
    sizes, F = _segment_layout(B)
    C = len(sizes)
    blocks, pos = [], 0
    for c, K in enumerate(sizes):
        size = K - 24 if C > 1 else K
        take = size - (F if c == 0 else 0)
        seg = bits[pos:pos + take]
        pos += take
        if c == 0:
            seg = np.concatenate([np.zeros(F, np.uint8), seg])
        if C > 1:
            seg = np.asarray(crc_append(CRC24B, seg), np.uint8)
        blocks.append(seg)
    assert pos == B
    return blocks, F


def desegment_tb(blocks, F: int) -> np.ndarray:
    """Invert `segment_tb`: strip fillers and per-block CRC24B."""
    C = len(blocks)
    out = []
    for c, b in enumerate(blocks):
        b = np.asarray(b, np.uint8)
        if C > 1:
            b = b[:-24]
        if c == 0:
            b = b[F:]
        out.append(b)
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# §5.1 batched DL-SCH transport-block chain: every same-shaped code
# block of a TB encodes/decodes in ONE dispatch (the blocks of one TB
# are equal-sized in the common case — at most two sizes ever exist).

def dlsch_block_sizes(A: int) -> tuple[list[int], int]:
    """Per-code-block sizes (transmission order) and filler count F for
    an A-bit payload (CRC24A appended before segmentation)."""
    return _segment_layout(A + 24)


def dlsch_rate_match_sizes(G: int, C: int, n_l: int = 1,
                           qm: int = 2) -> list[int]:
    """E per code block for G total channel bits (36.212 §5.1.4.1.2)."""
    unit = n_l * qm
    if G % unit:
        raise ValueError("G must be a multiple of N_L * Q_m")
    Gp = G // unit
    gamma = Gp % C
    return [unit * (Gp // C) if k <= C - gamma - 1 else unit * (-(-Gp // C))
            for k in range(C)]


def _dlsch_groups(sizes: list[int], Es: list[int], F: int):
    """Group block indices by identical (L, E, F) — one dispatch each."""
    groups: dict = {}
    for c, (L, E) in enumerate(zip(sizes, Es)):
        groups.setdefault((L, E, F if c == 0 else 0), []).append(c)
    return groups


def lte_dlsch_encode(payload, G: int, rv: int = 0, n_l: int = 1,
                     qm: int = 2, rsc: RscSpec = RscSpec()):
    """Full §5.1 transmit chain for one transport block.

    payload [A] -> CRC24A -> segmentation (CRC24B per block when C > 1,
    fillers) -> batched turbo encode + rate matching (one
    `lte_turbo_encode_batch` dispatch per distinct block shape) ->
    §5.1.5 concatenation.  Returns uint8 [G] channel bits.
    """
    from .crc import CRC24A, crc_append
    payload = np.asarray(payload, np.uint8)
    bits = np.asarray(crc_append(CRC24A, payload), np.uint8)
    blocks, F = segment_tb(bits)
    C = len(blocks)
    sizes = [b.size for b in blocks]
    Es = dlsch_rate_match_sizes(G, C, n_l, qm)
    outs: list = [None] * C
    for (L, E, Fk), idxs in _dlsch_groups(sizes, Es, F).items():
        batch = jnp.asarray(np.stack([blocks[i] for i in idxs]))
        tx = lte_turbo_encode_batch(batch, E, rv=rv, rsc=rsc, F=Fk)
        for j, i in enumerate(idxs):
            outs[i] = tx[j]
    return jnp.concatenate(outs, axis=-1)


def lte_dlsch_decode(llrs, A: int, rv: int = 0, n_iters: int = 6,
                     n_l: int = 1, qm: int = 2, rsc: RscSpec = RscSpec(),
                     qmax: int | None = 31):
    """Receive chain for one transport block (or a [Bt, G] batch).

    Splits the G LLRs per §5.1.5/§5.1.4.1.2, decodes every same-shaped
    code block in one batched `lte_turbo_decode` dispatch, checks the
    per-block CRC24B (C > 1), reassembles, and checks/strips CRC24A.

    Returns (payload [..., A] uint8, tb_ok bool [...], block_ok
    [..., C] bool).  `tb_ok` is the transport-block CRC24A verdict
    AND'd with every per-block CRC24B.
    """
    from .crc import CRC24A, CRC24B, crc_check
    llrs = jnp.asarray(llrs, jnp.int32)
    squeeze = llrs.ndim == 1
    if squeeze:
        llrs = llrs[None]
    lead = llrs.shape[:-1]
    G = llrs.shape[-1]
    sizes, F = dlsch_block_sizes(A)
    C = len(sizes)
    Es = dlsch_rate_match_sizes(G, C, n_l, qm)
    offs = np.concatenate([[0], np.cumsum(Es)])
    dec_blocks: list = [None] * C
    for (L, E, Fk), idxs in _dlsch_groups(sizes, Es, F).items():
        chunk = jnp.stack([llrs[..., offs[i]:offs[i] + E] for i in idxs],
                          axis=-2)                       # [..., n, E]
        flat = chunk.reshape((-1, E))
        bits, _ = lte_turbo_decode(flat, L, rv=rv, n_iters=n_iters,
                                   rsc=rsc, qmax=qmax, F=Fk)
        bits = bits.reshape(lead + (len(idxs), L))
        for j, i in enumerate(idxs):
            dec_blocks[i] = bits[..., j, :]
    if C > 1:
        block_ok = jnp.stack([crc_check(CRC24B, b) for b in dec_blocks],
                             axis=-1)
        dec_blocks = [b[..., :-24] for b in dec_blocks]  # strip CRC24B
    else:
        block_ok = jnp.ones(lead + (1,), bool)
    dec_blocks[0] = dec_blocks[0][..., F:]               # strip fillers
    tb = jnp.concatenate(dec_blocks, axis=-1)            # [..., A + 24]
    tb_ok = crc_check(CRC24A, tb) & jnp.all(block_ok, axis=-1)
    payload = tb[..., :A]
    if squeeze:
        payload, tb_ok, block_ok = payload[0], tb_ok[0], block_ok[0]
    return payload, tb_ok, block_ok


# ---------------------------------------------------------------------------
# One-call transport-channel chain (single code block, the common case).

def lte_turbo_encode(bits: np.ndarray, E: int, rv: int = 0,
                     rsc: RscSpec = RscSpec(),
                     Ncb: int | None = None, F: int = 0) -> np.ndarray:
    """Encode one code block (len in `LTE_BLOCK_SIZES`) to E channel bits.

    `F` filler bits (the block's first F positions, zeros from
    `segment_tb`) are <NULL> for bit selection and never transmitted.
    """
    bits = np.asarray(bits, np.uint8)
    L = bits.size
    perm = lte_qpp(L)
    d = turbo_mux_streams(turbo_mod.turbo_encode_np(rsc, bits, perm))
    return np.asarray(rate_match_turbo(d, E, rv, Ncb, F), np.uint8)


@functools.partial(jax.jit, static_argnames=(
    "L", "crc", "rv", "max_iters", "rsc", "Ncb", "qmax", "F"))
def lte_turbo_decode_early(llrs, L: int, crc=None, rv: int = 0,
                           max_iters: int = 8, rsc: RscSpec = RscSpec(),
                           Ncb: int | None = None, qmax: int | None = 31,
                           F: int = 0):
    """Batched receive chain with CRC-gated early termination.

    Like `lte_turbo_decode` but the iteration count is adaptive: the
    `lax.while_loop` exits once every block's CRC passes (see
    `turbo.turbo_decode_batch_early`).

    `crc` must be the CRC the decoded block actually CARRIES in its
    trailing 24 bits: the default CRC24B matches §5.1.2 code blocks of
    a segmented (C > 1) transport block; a SINGLE-block transport
    block (C = 1, A <= 6120) carries only the TB-level **CRC24A** —
    pass `crc=CRC24A` there, or early termination never fires and
    `ok` stays False for correct blocks.  Returns
    (bits [B, L], lapp, ok [B], iters_used).
    """
    from .crc import CRC24B
    crc = crc or CRC24B
    if jnp.ndim(llrs) == 1:
        # Single block: batch-of-1 through the same code path,
        # mirroring lte_turbo_decode.
        bits, lapp, ok, iters = lte_turbo_decode_early(
            jnp.asarray(llrs)[None], L, crc=crc, rv=rv,
            max_iters=max_iters, rsc=rsc, Ncb=Ncb, qmax=qmax, F=F)
        return bits[0], lapp[0], ok[0], iters
    filler = 0 if qmax is None else qmax
    d = derate_match_turbo(llrs, L + 4, rv, Ncb, F=F, qmax=qmax,
                           filler_llr=filler)
    fields = turbo_demux_tails(d)
    perm = lte_qpp(L)
    return turbo_mod.turbo_decode_batch_early(
        rsc, *fields, tuple(int(p) for p in perm), crc, max_iters)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def lte_turbo_encode_batch(bits, E: int, rv: int = 0,
                           rsc: RscSpec = RscSpec(),
                           Ncb: int | None = None, F: int = 0):
    """Jitted batched transmit chain: [B, L] bits -> [B, E] channel bits.

    One XLA program: block-Toeplitz matmul RSC encode of both constituents
    (`turbo.rsc_encode_batch`), tail multiplexing, and the rate-matching
    gather.  L must be in `LTE_BLOCK_SIZES`; the NumPy
    `lte_turbo_encode` stays as the single-block oracle.
    """
    bits = jnp.asarray(bits, jnp.uint8)
    L = bits.shape[-1]
    perm = lte_qpp(L)
    d = turbo_mux_streams(turbo_mod.turbo_encode_batch(rsc, bits, perm))
    return rate_match_turbo(d, E, rv, Ncb, F).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=(
    "L", "rv", "n_iters", "rsc", "Ncb", "qmax", "F"))
def lte_turbo_decode(llrs, L: int, rv: int = 0, n_iters: int = 6,
                     rsc: RscSpec = RscSpec(), Ncb: int | None = None,
                     qmax: int | None = 31, F: int = 0):
    """Decode E received LLRs (positive favors 0) back to L bits.

    One jitted program (one dispatch per call): scatter-add
    de-rate-matching (chase combining), tail demultiplex, iterative
    max-log-MAP (`turbo.turbo_decode_batch`).  Batched when `llrs` has a
    leading batch axis.  Returns (bits [..., L], a-posteriori LLRs).
    """
    filler = 0 if qmax is None else qmax
    if jnp.ndim(llrs) == 1:
        # Single block: batch-of-1 through the same code path.
        bits, lapp = lte_turbo_decode(
            jnp.asarray(llrs)[None], L, rv=rv, n_iters=n_iters, rsc=rsc,
            Ncb=Ncb, qmax=qmax, F=F)
        return bits[0], lapp[0]
    d = derate_match_turbo(llrs, L + 4, rv, Ncb, F=F, qmax=qmax,
                           filler_llr=filler)
    fields = turbo_demux_tails(d)
    return turbo_mod.turbo_decode_batch(rsc, *fields, lte_qpp(L), n_iters)
