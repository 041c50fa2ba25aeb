"""LTE rate matching (36.212 §5.1.4.2): vectorized index-map formulation
vs a literal per-bit transcription of the standard's pseudocode, plus
round-trip / combining properties and the one-call receive chain.

Beyond-reference scope (the reference stops at the codec); this is the
standard bit mapping the CRC-list TBCC receiver serves in production.
"""
import numpy as np
import pytest

import convolutionalencdec as fec
from convolutionalencdec.ops.crc import CRC8_LTE, crc_append
from convolutionalencdec.ops.ratematch import (
    NCOLS, SUBBLOCK_PERM, circular_buffer_map, derate_match, rate_match,
    rate_match_segments, ratematch_indices, subblock_interleave_map)

_NULL = object()


def _oracle_rate_match(streams, E):
    """Literal 36.212 §5.1.4.2: explicit matrices, per-bit while loop."""
    n, D = len(streams), len(streams[0])
    R = (D + NCOLS - 1) // NCOLS
    v = []
    for i in range(n):
        y = [_NULL] * (R * NCOLS - D) + list(streams[i])
        mat = [y[r * NCOLS:(r + 1) * NCOLS] for r in range(R)]
        vi = []
        for j in range(NCOLS):          # read permuted columns top-down
            for r in range(R):
                vi.append(mat[r][SUBBLOCK_PERM[j]])
        v.append(vi)
    w = [b for vi in v for b in vi]     # bit collection (circular buffer)
    e, j = [], 0
    while len(e) < E:                   # bit selection, k0 = 0, skip NULLs
        if w[j % len(w)] is not _NULL:
            e.append(w[j % len(w)])
        j += 1
    return e


@pytest.mark.parametrize("n,D,E", [
    (3, 40, 120),    # E == 3D: exact permutation
    (3, 40, 72),     # puncturing (DCI-like)
    (3, 40, 480),    # heavy repetition (PBCH-like: 40+CRC16 -> 1920/4)
    (3, 57, 100),    # D not a multiple of 32, E coprime-ish
    (2, 32, 65),     # n=2 mother code, E = 2D+1 wraps once
    (3, 7, 23),      # D < 32: all-NULL columns exist
])
def test_indices_match_literal_standard(n, D, E):
    streams = [[t * n + i for t in range(D)] for i in range(n)]
    want = _oracle_rate_match(streams, E)
    got = ratematch_indices(n, D, E)
    assert got.shape == (E,)
    assert list(got) == want


def test_full_buffer_is_permutation():
    for n, D in [(3, 40), (2, 100), (3, 6)]:
        wnn = circular_buffer_map(n, D)
        assert sorted(wnn) == list(range(n * D))


def test_subblock_map_nulls_and_coverage():
    for D in (7, 32, 40, 64, 57):
        m = subblock_interleave_map(D)
        R = (D + NCOLS - 1) // NCOLS
        assert m.size == R * NCOLS
        assert (m == -1).sum() == R * NCOLS - D
        assert sorted(m[m >= 0]) == list(range(D))


def test_rate_match_roundtrip_and_combining():
    spec = fec.LTE_TBCC_K7
    rng = np.random.default_rng(5)
    B, D = 4, 48
    llr = rng.integers(-7, 8, (B, D * spec.n)).astype(np.int32)

    # E == 3D: rate_match is a permutation; derate inverts it exactly.
    tx = np.asarray(rate_match(llr, spec, D, spec.n * D))
    back = np.asarray(derate_match(tx, spec, D)).reshape(B, -1)
    assert (back == llr).all()

    # E == 6D: every bit sent twice -> accumulator doubles.
    tx2 = np.asarray(rate_match(llr, spec, D, 2 * spec.n * D))
    back2 = np.asarray(derate_match(tx2, spec, D)).reshape(B, -1)
    assert (back2 == 2 * llr).all()

    # E < 3D: untransmitted slots are exactly the zero-LLR erasures.
    E = 100
    idx = ratematch_indices(spec.n, D, E)
    backp = np.asarray(derate_match(tx[:, :E], spec, D)).reshape(B, -1)
    sent = np.zeros(D * spec.n, bool)
    sent[idx] = True
    assert (backp[:, ~sent] == 0).all()
    assert (backp[:, sent] == llr[:, sent]).all()

    # Chase combining: summing two transmissions' accumulators equals
    # the scatter-add over both (the standard's HARQ soft buffer).
    a = np.asarray(derate_match(tx[:, :E], spec, D)).reshape(B, -1)
    b = np.asarray(derate_match(tx, spec, D)).reshape(B, -1)
    np.add.at(want := np.zeros((B, D * spec.n), np.int32),
              (slice(None), idx), tx[:, :E])
    want += llr  # full-cycle transmission contributes each bit once
    assert (a + b == want).all()

    # qmax clip path returns kernel-ready int8.
    q = np.asarray(derate_match(tx2, spec, D, qmax=7))
    assert q.dtype == np.int8 and q.shape == (B, D, spec.n)
    assert (q == np.clip(back2.reshape(B, D, spec.n), -7, 7)).all()

    # segment-form rate_match agrees with flat.
    seg = llr.reshape(B, D, spec.n)
    assert (np.asarray(rate_match_segments(seg, spec, 2 * spec.n * D))
            == tx2).all()


def test_ratematched_tbcc_crc_one_call():
    # End-to-end standard chain: CRC attach -> TBCC encode -> rate match
    # (repetition) -> bipolar LLRs with flips -> one-call receiver.
    spec, crc = fec.LTE_TBCC_K7, CRC8_LTE
    from convolutionalencdec.ops.tailbiting import (
        viterbi_decode_tailbiting_crc_soft,
        viterbi_decode_tailbiting_ratematched_crc)
    rng = np.random.default_rng(11)
    B, D, E = 8, 48, 200  # E > 3D=144: 56 bits repeated
    payload = rng.integers(0, 2, (B, D - crc.width), dtype=np.uint8)
    msgs = np.asarray(crc_append(crc, payload))
    from convolutionalencdec.ops.channel import segments_to_bits
    coded = np.asarray(fec.encode_tailbiting(spec, msgs))
    cbits = segments_to_bits(coded, spec.n)  # [B, D*n] step-major
    tx = np.asarray(rate_match(cbits, spec, D, E)).astype(np.uint8)
    flip = rng.random(tx.shape) < 0.02
    rx = ((1 - 2 * (tx ^ flip).astype(np.int8)) * 3).astype(np.int8)

    one = viterbi_decode_tailbiting_ratematched_crc(spec, crc, rx, D, 4)
    q = np.asarray(derate_match(rx, spec, D, qmax=7))
    two = viterbi_decode_tailbiting_crc_soft(spec, crc, q, 4)
    for a, b in zip(one, two):
        assert (np.asarray(a) == np.asarray(b)).all()
    out, ok, _ = one
    assert (np.asarray(out) == msgs).all() and np.asarray(ok).all()


def test_ratematch_errors():
    with pytest.raises(ValueError):
        subblock_interleave_map(0)
    with pytest.raises(ValueError):
        ratematch_indices(2, 8, 0)
