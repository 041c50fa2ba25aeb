"""LTE transport-chain tests (36.212 §5.1.2–5.1.4.1): QPP table,
termination multiplexing, turbo rate matching, segmentation, and the
one-call encode/decode chain."""

import numpy as np
import pytest

from convolutionalencdec.ops import lte
from convolutionalencdec.ops.crc import CRC24B, crc_check
from convolutionalencdec.ops.turbo import RscSpec, turbo_encode_np

RSC = RscSpec()


def _llr(bits, q=4):
    """Hard bits -> quantized LLRs, positive favors 0."""
    return (1 - 2 * np.asarray(bits, np.int32)) * q


def test_qpp_table_complete_and_bijective():
    # 188 sizes: 40..512 step 8, 528..1024 step 16, 1056..2048 step 32,
    # 2112..6144 step 64 (36.212 §5.1.3.2.3).
    expected = (list(range(40, 512 + 1, 8)) + list(range(528, 1024 + 1, 16))
                + list(range(1056, 2048 + 1, 32))
                + list(range(2112, 6144 + 1, 64)))
    assert list(lte.LTE_BLOCK_SIZES) == expected
    assert len(expected) == 188
    for L in lte.LTE_BLOCK_SIZES:
        pi = lte.lte_qpp(L)  # raises if not a permutation
        assert pi.shape == (L,)


def test_batch_encoder_matches_oracle():
    from convolutionalencdec.ops.turbo import turbo_encode_batch_np
    rng = np.random.default_rng(7)
    L = 48
    perm = lte.lte_qpp(L)
    bits = rng.integers(0, 2, (4, L), dtype=np.uint8)
    per_block = [turbo_encode_np(RSC, b, perm) for b in bits]
    batched = turbo_encode_batch_np(RSC, bits, perm)
    for key in batched:
        np.testing.assert_array_equal(
            batched[key], np.stack([e[key] for e in per_block]), err_msg=key)
    # batched mux == per-block mux
    d = lte.turbo_mux_streams(batched)
    assert d.shape == (4, 3, L + 4)
    for i, e in enumerate(per_block):
        np.testing.assert_array_equal(d[i], lte.turbo_mux_streams(e))


def test_mux_demux_roundtrip():
    rng = np.random.default_rng(0)
    L = 40
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    enc = turbo_encode_np(RSC, bits, lte.lte_qpp(L))
    d = lte.turbo_mux_streams(enc)
    assert d.shape == (3, L + 4)
    f = lte.turbo_demux_tails(_llr(d))
    np.testing.assert_array_equal(f[0], _llr(enc["sys"]))
    np.testing.assert_array_equal(f[1], _llr(enc["par1"]))
    np.testing.assert_array_equal(f[2], _llr(enc["par2"]))
    np.testing.assert_array_equal(f[3], _llr(enc["sys_tail1"]))
    np.testing.assert_array_equal(f[4], _llr(enc["par_tail1"]))
    np.testing.assert_array_equal(f[5], _llr(enc["sys_tail2"]))
    np.testing.assert_array_equal(f[6], _llr(enc["par_tail2"]))


def test_w_map_covers_every_coded_bit_once():
    D = 44  # L=40
    w = lte._turbo_w_map(D, F=0)
    KP = -(-D // 32) * 32
    assert w.shape == (3 * KP,)
    live = w[w >= 0]
    assert live.size == 3 * D
    assert sorted(live.tolist()) == list(range(3 * D))


def test_ratematch_derate_roundtrip_and_chase():
    rng = np.random.default_rng(1)
    L, D = 40, 44
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    d = lte.turbo_mux_streams(turbo_encode_np(RSC, bits, lte.lte_qpp(L)))
    E = 3 * D  # one full pass over the live buffer
    tx = np.asarray(lte.rate_match_turbo(d, E))
    rx = np.asarray(lte.derate_match_turbo(_llr(tx), D))
    np.testing.assert_array_equal(rx, _llr(d))
    # Repetition chase-combines: doubling E doubles every LLR magnitude.
    tx2 = np.asarray(lte.rate_match_turbo(d, 2 * E))
    rx2 = np.asarray(lte.derate_match_turbo(_llr(tx2), D))
    np.testing.assert_array_equal(rx2, 2 * _llr(d))


def test_rv_offsets_differ_but_same_content():
    D = 44
    i0 = lte.turbo_ratematch_indices(D, 64, rv=0)
    i2 = lte.turbo_ratematch_indices(D, 64, rv=2)
    assert not np.array_equal(i0, i2)
    full0 = lte.turbo_ratematch_indices(D, 3 * D, rv=0)
    full2 = lte.turbo_ratematch_indices(D, 3 * D, rv=2)
    assert sorted(full0.tolist()) == sorted(full2.tolist())


def test_lte_turbo_encode_batch_matches_oracle():
    rng = np.random.default_rng(21)
    B, L = 6, 104
    bits = rng.integers(0, 2, (B, L), dtype=np.uint8)
    for E, rv, F in ((3 * 108, 0, 0), (150, 2, 4)):
        got = np.asarray(lte.lte_turbo_encode_batch(bits, E, rv=rv, F=F))
        want = np.stack([lte.lte_turbo_encode(b, E, rv=rv, F=F)
                         for b in bits])
        np.testing.assert_array_equal(got, want, err_msg=f"E={E} rv={rv}")


def test_e2e_noiseless_exact_and_punctured():
    rng = np.random.default_rng(2)
    L = 40
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    for E in (3 * 44, 100):  # full buffer; punctured to rate 0.4
        tx = lte.lte_turbo_encode(bits, E)
        dec, _ = lte.lte_turbo_decode(_llr(tx), L)
        np.testing.assert_array_equal(np.asarray(dec), bits, err_msg=f"E={E}")


def test_e2e_noisy_repetition_batch():
    rng = np.random.default_rng(3)
    B, L, E = 8, 104, 3 * 108 * 2
    bits = rng.integers(0, 2, (B, L), dtype=np.uint8)
    llrs = np.stack([_llr(lte.lte_turbo_encode(b, E)) for b in bits])
    flip = rng.random(llrs.shape) < 0.08
    llrs = np.where(flip, -llrs, llrs)
    dec, _ = lte.lte_turbo_decode(llrs, L, n_iters=6)
    assert (np.asarray(dec) == bits).mean() > 0.999


def test_rv_chase_combining_recovers():
    """Two transmissions at different rv combine into a decodable set."""
    rng = np.random.default_rng(4)
    L, D, E = 40, 44, 70  # each rv alone is heavily punctured
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    rx = sum(
        np.asarray(lte.derate_match_turbo(
            _llr(lte.lte_turbo_encode(bits, E, rv=rv)), D, rv=rv))
        for rv in (0, 2))
    fields = lte.turbo_demux_tails(rx)
    from convolutionalencdec.ops.turbo import turbo_decode
    dec, _ = turbo_decode(RSC, *fields, tuple(lte.lte_qpp(L)), 6)
    np.testing.assert_array_equal(np.asarray(dec), bits)


def test_segment_sizes_single_block():
    C, Kp, Km, Cp, Cm = lte.segment_sizes(100)
    assert (C, Kp, Cp, Cm) == (1, 104, 1, 0)
    blocks, F = lte.segment_tb(np.ones(100, np.uint8))
    assert F == 4 and len(blocks) == 1 and blocks[0].size == 104
    assert (blocks[0][:4] == 0).all()


def test_segmentation_roundtrip_multi_block():
    rng = np.random.default_rng(5)
    B = 10000
    bits = rng.integers(0, 2, B, dtype=np.uint8)
    C, Kp, Km, Cp, Cm = lte.segment_sizes(B)
    assert C == 2
    blocks, F = lte.segment_tb(bits)
    assert len(blocks) == C
    assert Cp * Kp + Cm * Km == B + 24 * C + F
    for b in blocks:
        assert b.size in lte.LTE_BLOCK_SIZES
        assert bool(crc_check(CRC24B, b))  # per-block CRC attached
    np.testing.assert_array_equal(lte.desegment_tb(blocks, F), bits)


def test_filler_bits_are_nulls_in_ratematch():
    """Filler positions (streams 0/1) are never transmitted and come
    back as the requested strong LLR."""
    L, D, F = 104, 108, 4
    idx = lte.turbo_ratematch_indices(D, 3 * D, F=F)
    for f in range(F):
        assert f not in idx          # stream 0 filler
        assert D + f not in idx      # stream 1 filler
    rx = np.asarray(lte.derate_match_turbo(
        np.ones(3 * D, np.int32), D, F=F, filler_llr=99))
    assert (rx[0, :F] == 99).all() and (rx[1, :F] == 99).all()


def test_dlsch_batched_runner_vs_block_loop():
    """One-call batched TB chain == the per-block Python loop, and the
    §5.1.4.1.2 E split covers G exactly."""
    rng = np.random.default_rng(22)
    A = 7000                       # C=2, equal-ish sizes, F > 0
    G = 3 * 7500 * 2
    payload = rng.integers(0, 2, A, dtype=np.uint8)
    tx = np.asarray(lte.lte_dlsch_encode(payload, G))
    assert tx.shape == (G,)
    # manual loop through the single-block primitives
    from convolutionalencdec.ops.crc import CRC24A, crc_append
    bits = np.asarray(crc_append(CRC24A, payload), np.uint8)
    blocks, F = lte.segment_tb(bits)
    Es = lte.dlsch_rate_match_sizes(G, len(blocks))
    assert sum(Es) == G
    manual = np.concatenate([
        lte.lte_turbo_encode(b, E, F=(F if c == 0 else 0))
        for c, (b, E) in enumerate(zip(blocks, Es))])
    np.testing.assert_array_equal(tx, manual)
    # decode: noiseless strong LLRs round-trip, CRCs pass
    dec, tb_ok, blk_ok = lte.lte_dlsch_decode(_llr(tx, 8), A, n_iters=3)
    assert bool(tb_ok) and bool(np.asarray(blk_ok).all())
    np.testing.assert_array_equal(np.asarray(dec), payload)
    # garbaging one block must flip that block's CRC and tb_ok
    bad = _llr(tx, 8).copy()
    bad[:Es[0]] = rng.integers(-8, 9, Es[0])
    _, tb_ok2, blk_ok2 = lte.lte_dlsch_decode(bad, A, n_iters=2)
    assert not bool(tb_ok2)
    assert not bool(np.asarray(blk_ok2)[0])
    assert bool(np.asarray(blk_ok2)[1])      # other block unaffected


def test_dlsch_batched_tb_axis():
    """A [Bt, G] batch of transport blocks decodes in the same grouped
    dispatches."""
    rng = np.random.default_rng(23)
    A, G = 2048, 3 * 2100
    payloads = rng.integers(0, 2, (3, A), dtype=np.uint8)
    txs = np.stack([np.asarray(lte.lte_dlsch_encode(p, G))
                    for p in payloads])
    dec, tb_ok, _ = lte.lte_dlsch_decode(_llr(txs, 6), A, n_iters=3)
    assert np.asarray(tb_ok).all()
    np.testing.assert_array_equal(np.asarray(dec), payloads)


def test_segmented_tb_e2e():
    """Full DL-SCH-style chain: segment -> encode -> decode -> reassemble."""
    rng = np.random.default_rng(6)
    B = 7000  # > 6144 forces C=2 with fillers
    tb = rng.integers(0, 2, B, dtype=np.uint8)
    blocks, F = lte.segment_tb(tb)
    out = []
    for c, blk in enumerate(blocks):
        L = blk.size
        Fc = F if c == 0 else 0
        tx = lte.lte_turbo_encode(blk, E=3 * (L + 4), F=Fc)
        dec, _ = lte.lte_turbo_decode(_llr(tx), L, n_iters=4, F=Fc)
        dec = np.asarray(dec)
        assert bool(crc_check(CRC24B, dec))
        out.append(dec)
    np.testing.assert_array_equal(lte.desegment_tb(out, F), tb)


def test_single_block_decode_honors_use_kernel():
    """1-D input routes through the same batched code path: the
    single-block result equals the batched row and decodes the
    message."""
    rng = np.random.default_rng(17)
    L = 40
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    E = 3 * (L + 4)
    tx = np.asarray(lte.lte_turbo_encode(bits, E))
    q = ((1 - 2 * tx.astype(np.int32)) * 6).astype(np.int32)
    kb, kl = lte.lte_turbo_decode(q, L, n_iters=2)
    bb, bl = lte.lte_turbo_decode(q[None], L, n_iters=2)
    np.testing.assert_array_equal(np.asarray(kl), np.asarray(bl)[0])
    np.testing.assert_array_equal(np.asarray(kb), np.asarray(bb)[0])
    np.testing.assert_array_equal(np.asarray(kb), bits)
