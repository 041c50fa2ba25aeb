"""CRC module: matmul formulation vs the serial LFSR oracle, and the
CRC-aided tail-biting list decode (the batched scan receivers).

The CRC layer is a beyond-reference extension (the reference counts raw
bit errors, berTestK7.c:163); the receive chain it enables — soft wrap
Viterbi list + CRC winner selection — is the production LTE TBCC path.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import convolutionalencdec as fec
from convolutionalencdec.ops.crc import (
    CRC6_NR, CRC8_LTE, CRC11_NR, CRC16_CCITT, CRC24A, CRC24B, CrcSpec,
    crc_append, crc_bits, crc_check, crc_remainder_np)

ALL_CRCS = [CRC6_NR, CRC8_LTE, CRC11_NR, CRC16_CCITT, CRC24A, CRC24B]


@pytest.mark.parametrize("crc", ALL_CRCS, ids=lambda c: f"w{c.width}")
def test_matmul_matches_lfsr_oracle(crc):
    rng = np.random.default_rng(42 + crc.width)
    for L in (crc.width, 40, 121):
        bits = rng.integers(0, 2, (5, L), dtype=np.uint8)
        got = np.asarray(crc_bits(crc, bits))
        for i in range(5):
            want = crc_remainder_np(crc, bits[i])
            got_int = int("".join(map(str, got[i])), 2)
            assert got_int == want, (crc, L, i)


def test_nonzero_init_and_xorout():
    crc = CrcSpec(16, 0x1021, init=0xFFFF, xor_out=0xFFFF)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (4, 73), dtype=np.uint8)
    got = np.asarray(crc_bits(crc, bits))
    for i in range(4):
        want = crc_remainder_np(crc, bits[i])
        assert int("".join(map(str, got[i])), 2) == want


def test_known_vector_crc16_ccitt():
    # "123456789" ASCII, MSb-first: CRC-16/XMODEM (poly 0x1021, init 0,
    # no reflection, no xorout) = 0x31C3 — the published check value.
    data = b"123456789"
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    assert crc_remainder_np(CRC16_CCITT, bits) == 0x31C3
    got = np.asarray(crc_bits(CRC16_CCITT, bits[None]))[0]
    assert int("".join(map(str, got)), 2) == 0x31C3


def test_append_check_roundtrip_and_error_detection():
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 2, (16, 100), dtype=np.uint8)
    block = np.asarray(crc_append(CRC16_CCITT, msgs))
    assert block.shape == (16, 116)
    assert np.asarray(crc_check(CRC16_CCITT, block)).all()
    # Any single-bit flip must be detected (CRC distance >= 2).
    bad = block.copy()
    for i in range(16):
        bad[i, rng.integers(0, 116)] ^= 1
    assert not np.asarray(crc_check(CRC16_CCITT, bad)).any()


def test_crcspec_validation():
    with pytest.raises(ValueError):
        CrcSpec(0, 0x1)
    with pytest.raises(ValueError):
        CrcSpec(8, 0x1FF)


def _tb_crc_setup(rng, spec, crc, B, L, flip_p):
    payload = rng.integers(0, 2, (B, L - crc.width), dtype=np.uint8)
    msgs = np.asarray(crc_append(crc, payload))
    coded = np.asarray(fec.encode_tailbiting(spec, msgs)).copy()
    flip = rng.random(coded.shape) < flip_p
    coded ^= (flip * rng.integers(1, 2 ** spec.n, coded.shape)).astype(np.uint8)
    return msgs, coded


def test_scan_list_candidate0_equals_argmin_decode():
    spec = fec.NASA_K7
    rng = np.random.default_rng(11)
    msgs, coded = _tb_crc_setup(rng, spec, CRC16_CCITT, 4, 96, 0.04)
    wl = fec.tailbiting.default_wrap(spec)
    for i in range(4):
        # The list trellis ends at the message end (left wrap only);
        # candidate 0 is the argmin decode of that same trellis.
        plain = np.asarray(fec.viterbi_decode_tailbiting(
            spec, coded[i], (wl, 0)))
        cands, mets = fec.viterbi_decode_tailbiting_list(spec, coded[i], 4)
        cands, mets = np.asarray(cands), np.asarray(mets)
        assert (cands[0] == plain).all()
        assert (np.diff(mets) >= 0).all()
        # Left-only extension keeps candidates distinct near the end.
        assert any((cands[l] != cands[0]).any() for l in range(1, 4))


def test_kernel_crc_list_improves_block_errors_hard():
    spec = fec.NASA_K7
    crc = CRC16_CCITT
    import jax
    from convolutionalencdec.ops.tailbiting import (
        viterbi_decode_tailbiting_crc)
    rng = np.random.default_rng(13)
    B, L = 64, 96
    msgs, coded = _tb_crc_setup(rng, spec, crc, B, L, 0.09)
    plain = np.asarray(jax.vmap(
        lambda c: fec.viterbi_decode_tailbiting(spec, c))(coded))
    out, ok, chosen = viterbi_decode_tailbiting_crc(spec, crc, coded, 8)
    out, ok, chosen = np.asarray(out), np.asarray(ok), np.asarray(chosen)
    plain_blkerr = (plain != msgs).any(axis=1)
    list_blkerr = (out != msgs).any(axis=1)
    # The selection includes the plain decode, so no block it got right
    # can be lost — and at this noise level some blocks the plain
    # decode missed are rescued by a deeper CRC-passing candidate.
    assert not (list_blkerr & ~plain_blkerr).any()
    rescued = (plain_blkerr & ~list_blkerr).sum()
    assert rescued >= 1, "noise level should produce rescued blocks"
    # ok=True outputs really satisfy the CRC; where the plain decode is
    # correct it passes its own CRC, so chosen stays 0.
    assert np.asarray(crc_check(crc, out[ok])).all()
    assert (chosen[~plain_blkerr] == 0).all()
    assert (chosen[plain_blkerr & ~list_blkerr] >= 1).all()


def test_kernel_crc_soft_matches_hard_on_pseudo_llrs():
    spec = fec.LTE_TBCC_K7
    crc = CRC8_LTE
    from convolutionalencdec.ops.tailbiting import (
        viterbi_decode_tailbiting_crc, viterbi_decode_tailbiting_crc_soft)
    rng = np.random.default_rng(14)
    B, L = 8, 64
    msgs, coded = _tb_crc_setup(rng, spec, crc, B, L, 0.04)
    # +/-1 pseudo-LLRs reproduce hard Hamming metrics exactly.
    planes = np.stack([(coded >> b) & 1 for b in range(spec.n)], axis=-1)
    qllrs = (1 - 2 * planes.astype(np.int8)).astype(np.int8)
    hard = viterbi_decode_tailbiting_crc(spec, crc, coded, 4)
    soft = viterbi_decode_tailbiting_crc_soft(spec, crc, qllrs, 4)
    for h, s in zip(hard, soft):
        assert (np.asarray(h) == np.asarray(s)).all()


def test_list_size_validation():
    spec = fec.NASA_K7
    from convolutionalencdec.ops.tailbiting import (
        viterbi_decode_tailbiting_crc)
    with pytest.raises(ValueError):
        viterbi_decode_tailbiting_crc(
            spec, CRC16_CCITT, np.zeros((4, 64), np.uint8), 65)


def test_bler_curve_tbcc_smoke():
    # Smoke of the BLER curve runner: list selection can only improve
    # block errors, false accepts stay rare at short CRC16.
    from convolutionalencdec.harness import run_bler_curve_tbcc
    import convolutionalencdec as fec
    pts = run_bler_curve_tbcc(
        fec.NASA_K7, CRC16_CCITT, [2.0], n_packets=64, payload_bits=48,
        list_size=4, batch=64, verbose=False)
    p = pts[0]
    assert p["blocks"] == 64
    assert p["crc_list_bler"] <= p["plain_bler"]
    assert p["false_accept"] <= p["crc_list_bler"]


def test_punctured_tbcc_crc_one_call():
    # One-call LTE-style chain == manual depuncture + CRC-list decode,
    # and it recovers clean blocks end-to-end at rate 1/2 (keep 4 of 6
    # coded bits of the rate-1/3 mother code, LTE-rate-matching style).
    spec, crc = fec.LTE_TBCC_K7, CRC8_LTE
    from convolutionalencdec.ops.puncture import (
        puncture_bits, depuncture_llrs)
    # local n=3 pattern (rows = generators) — distinct from the
    # library's n=2 PUNCTURE_HALF preset.
    PUNCTURE_HALF = ((1, 1), (1, 0), (1, 0))
    from convolutionalencdec.ops.channel import segments_to_bits
    from convolutionalencdec.ops.tailbiting import (
        viterbi_decode_tailbiting_crc_soft,
        viterbi_decode_tailbiting_punctured_crc)
    rng = np.random.default_rng(21)
    B, L = 8, 96
    payload = rng.integers(0, 2, (B, L - 8), dtype=np.uint8)
    msgs = np.asarray(crc_append(crc, payload))
    coded = np.asarray(fec.encode_tailbiting(spec, msgs))
    cbits = np.asarray(segments_to_bits(coded, spec.n))
    tx = np.asarray(puncture_bits(cbits, PUNCTURE_HALF, L))
    # light noise on the transmitted bits
    flip = rng.random(tx.shape) < 0.01
    rx = (1 - 2 * (tx ^ flip).astype(np.int8)) * 5
    one = viterbi_decode_tailbiting_punctured_crc(
        spec, crc, rx, PUNCTURE_HALF, L, 4)
    q = np.asarray(depuncture_llrs(rx, PUNCTURE_HALF, L)).reshape(B, L, spec.n)
    two = viterbi_decode_tailbiting_crc_soft(spec, crc, q, 4)
    for a, b in zip(one, two):
        assert (np.asarray(a) == np.asarray(b)).all()
    out, ok, _ = one
    out, ok = np.asarray(out), np.asarray(ok)
    assert (out == msgs).all() and ok.all()
