"""Turbo codes (ops/turbo.py): RSC encoder vs a literal shift-register
oracle, max-log-MAP vs brute-force path enumeration (exact integer
match), QPP properties, and iterative decoding gain over AWGN.
"""
import numpy as np
import pytest

from convolutionalencdec.ops import lte
from convolutionalencdec.ops.turbo import (
    QPP_TABLE, RscSpec, _rsc_impulse, qpp_interleaver,
    rsc_encode_batch, rsc_encode_batch_np, rsc_encode_np, rsc_maxlogmap,
    rsc_step, rsc_tables, turbo_decode, turbo_decode_batch,
    turbo_encode_batch, turbo_encode_batch_np, turbo_encode_np)

RSC = RscSpec()  # LTE: K=4, g0=13, g1=15 octal


def _rsc_oracle(bits):
    """Literal LTE RSC (36.212 §5.1.3.2 figure): registers s1,s2,s3,
    feedback = s2^s3, w = u^fb, parity = w^s1^s3, shift."""
    s1 = s2 = s3 = 0
    sys_, par = [], []
    for u in bits:
        fb = s2 ^ s3
        w = int(u) ^ fb
        par.append(w ^ s1 ^ s3)
        sys_.append(int(u))
        s1, s2, s3 = w, s1, s2
    st, pt = [], []
    for _ in range(3):
        u = s2 ^ s3          # forces w = 0
        w = 0
        pt.append(w ^ s1 ^ s3)
        st.append(u)
        s1, s2, s3 = w, s1, s2
    assert (s1, s2, s3) == (0, 0, 0)
    return (np.array(sys_, np.uint8), np.array(par, np.uint8),
            np.array(st, np.uint8), np.array(pt, np.uint8))


def test_rsc_encoder_vs_literal_oracle():
    rng = np.random.default_rng(0)
    for L in (1, 7, 40):
        bits = rng.integers(0, 2, L, dtype=np.uint8)
        got = rsc_encode_np(RSC, bits)
        want = _rsc_oracle(bits)
        for g, w in zip(got, want):
            assert (g == w).all()


def test_rsc_impulse_lte_periodic():
    # 1/g_fb for g_fb=13 octal is purely periodic with period 7:
    # [1,0,1,1,1,0,0] — the Toeplitz encode matrix is built from it.
    h = _rsc_impulse(RSC, 21)
    assert list(h[:7]) == [1, 0, 1, 1, 1, 0, 0]
    assert (h[7:14] == h[:7]).all() and (h[14:] == h[:7]).all()


def test_rsc_encode_batch_jit_vs_oracle():
    rng = np.random.default_rng(12)
    for spec in (RSC, RscSpec(K=5, g_fb=0o23, g_fw=0o35),
                 RscSpec(K=3, g_fb=0o7, g_fw=0o5)):
        for L in (1, 2, 6, 7, 8, 40, 129):
            bits = rng.integers(0, 2, (5, L), dtype=np.uint8)
            want = rsc_encode_batch_np(spec, bits)
            got = rsc_encode_batch(spec, bits)
            for g, w in zip(got, want):
                assert (np.asarray(g) == w).all(), (spec, L)


def test_rsc_encode_batch_nonperiodic_gfb():
    # g_fb without the D^S tap: impulse response has a transient (not
    # purely periodic) — the Toeplitz matmul needs no periodicity.
    spec = RscSpec(K=4, g_fb=0o16, g_fw=0o15)   # 0b1110: no D^3 tap
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2, (4, 50), dtype=np.uint8)
    want = rsc_encode_batch_np(spec, bits)
    got = rsc_encode_batch(spec, bits)
    for g, w in zip(got, want):
        assert (np.asarray(g) == w).all()


def test_turbo_encode_batch_jit_vs_np():
    rng = np.random.default_rng(14)
    L = 64
    pi = qpp_interleaver(L)
    bits = rng.integers(0, 2, (7, L), dtype=np.uint8)
    want = turbo_encode_batch_np(RSC, bits, pi)
    got = turbo_encode_batch(RSC, bits, pi)
    for k in want:
        assert (np.asarray(got[k]) == want[k]).all(), k


def test_rsc_tables_match_step():
    nxt, par, prev, pu = rsc_tables(RSC)
    for s in range(8):
        for u in range(2):
            ns, x, z = rsc_step(RSC, s, u)
            assert nxt[u, s] == ns and par[u, s] == z and x == u
    # prev/pu invert nxt
    for d in range(8):
        for e in range(2):
            assert nxt[pu[e, d], prev[e, d]] == d


def test_rsc_spec_validation():
    with pytest.raises(ValueError):
        RscSpec(K=4, g_fb=0o5, g_fw=0o15)   # no current-input tap
    with pytest.raises(ValueError):
        RscSpec(K=4, g_fb=0o13, g_fw=0o37)  # wider than K


def test_qpp_known_values_and_permutation():
    pi = qpp_interleaver(40)
    assert list(pi[:4]) == [0, 13, 6, 19]   # (3i + 10i^2) mod 40
    assert sorted(pi) == list(range(40))
    # the single source of truth is the full 36.212 table
    assert len(QPP_TABLE) == 188
    assert sorted(qpp_interleaver(48)) == list(range(48))
    for L in (40, 512, 6144):
        f1, f2 = QPP_TABLE[L]
        assert (qpp_interleaver(L) == qpp_interleaver(L, f1, f2)).all()
    with pytest.raises(ValueError):
        qpp_interleaver(44)                 # not an LTE block size
    with pytest.raises(ValueError):
        qpp_interleaver(40, 2, 3)           # not bijective


def _llrs_for(bits, mag=8):
    return ((1 - 2 * np.asarray(bits, np.int32)) * mag).astype(np.int32)


def test_maxlogmap_matches_bruteforce_exactly():
    # L=6: enumerate all 64 terminated codewords; the a-posteriori LLR
    # is min(total cost | bit=1) - min(total cost | bit=0) — integer-
    # exact against the scan.
    rng = np.random.default_rng(3)
    L = 6
    l_sys = rng.integers(-9, 10, L).astype(np.int32)
    l_par = rng.integers(-9, 10, L).astype(np.int32)
    l_apr = rng.integers(-5, 6, L).astype(np.int32)
    l_st = rng.integers(-9, 10, 3).astype(np.int32)
    l_pt = rng.integers(-9, 10, 3).astype(np.int32)
    best = {0: {}, 1: {}}
    for m in range(1 << L):
        bits = np.array([(m >> i) & 1 for i in range(L)], np.uint8)
        sys_, par, st, pt = rsc_encode_np(RSC, bits)
        c = (int(np.dot(bits, l_sys + l_apr)) + int(np.dot(par, l_par))
             + int(np.dot(st, l_st)) + int(np.dot(pt, l_pt)))
        for t in range(L):
            d = best[bits[t]]
            d[t] = min(d.get(t, 1 << 60), c)
    want = np.array([best[1][t] - best[0][t] for t in range(L)], np.int32)
    got = np.asarray(rsc_maxlogmap(RSC, l_sys, l_par, l_apr, l_st, l_pt))
    assert (got == want).all()


def _turbo_tx(rng, B, L, pi):
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    streams = [turbo_encode_np(RSC, m, pi) for m in msgs]
    enc = {k: np.stack([s[k] for s in streams]) for k in streams[0]}
    return msgs, enc


def test_turbo_decode_noiseless_and_gain():
    rng = np.random.default_rng(7)
    L = 40
    pi = qpp_interleaver(L)
    msgs, enc = _turbo_tx(rng, 4, L, pi)
    args = [_llrs_for(enc["sys"]), _llrs_for(enc["par1"]),
            _llrs_for(enc["par2"]),
            _llrs_for(enc["sys_tail1"]), _llrs_for(enc["par_tail1"]),
            _llrs_for(enc["sys_tail2"]), _llrs_for(enc["par_tail2"])]
    bits, lapp = turbo_decode_batch(RSC, *args, perm=pi, n_iters=2)
    assert (np.asarray(bits) == msgs).all()

    # AWGN at 2 dB Eb/N0 (rate L/(3L+12)): more iterations must not
    # hurt, and the decoded BER must be far below the raw channel BER.
    B = 192
    msgs, enc = _turbo_tx(rng, B, L, pi)
    rate = L / (3 * L + 12)
    sigma = float(np.sqrt(1 / (2 * rate * 10 ** (2.0 / 10))))

    def llr(bits01):
        x = 1.0 - 2.0 * bits01.astype(np.float64)
        y = x + sigma * rng.standard_normal(x.shape)
        return np.clip(np.round(2 * y / sigma ** 2), -31, 31).astype(np.int32)

    args = [llr(enc["sys"]), llr(enc["par1"]), llr(enc["par2"]),
            llr(enc["sys_tail1"]), llr(enc["par_tail1"]),
            llr(enc["sys_tail2"]), llr(enc["par_tail2"])]
    raw_ber = (np.asarray(args[0]) < 0).astype(int)
    raw_ber = (raw_ber != msgs).mean()
    b1, _ = turbo_decode_batch(RSC, *args, perm=pi, n_iters=1)
    b6, _ = turbo_decode_batch(RSC, *args, perm=pi, n_iters=6)
    ber1 = (np.asarray(b1) != msgs).mean()
    ber6 = (np.asarray(b6) != msgs).mean()
    assert ber6 <= ber1
    assert ber6 < raw_ber / 5
    # single-block API agrees with the batch
    one, _ = turbo_decode(RSC, *[a[0] for a in args],
                          perm=tuple(int(p) for p in pi), n_iters=6)
    assert (np.asarray(one) == np.asarray(b6)[0]).all()


def test_early_termination_crc():
    """CRC-gated early exit: clean batch stops after one iteration with
    every block latched correct; noisy batch never false-accepts."""
    from convolutionalencdec.ops.crc import CRC24B, crc_append
    rng = np.random.default_rng(41)
    B, L = 8, 40
    payload = rng.integers(0, 2, (B, L - 24), dtype=np.uint8)
    msgs = np.asarray(crc_append(CRC24B, payload))
    E = 3 * (L + 4)
    tx = np.asarray(lte.lte_turbo_encode_batch(msgs, E))
    q = ((1 - 2 * tx.astype(np.int32)) * 8).astype(np.int32)
    bits, _, ok, iters = lte.lte_turbo_decode_early(q, L)
    assert int(iters) == 1
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(bits), msgs)
    # heavy noise: whatever passes must be RIGHT (no false accepts),
    # and passed blocks' outputs are latched (match the message).
    flip = rng.random(q.shape) < 0.12
    qn = np.where(flip, -q, q)
    bits, _, ok, iters = lte.lte_turbo_decode_early(qn, L, max_iters=4)
    ok = np.asarray(ok)
    bad = (np.asarray(bits) != msgs).any(1)
    assert not (ok & bad).any()
    assert 1 <= int(iters) <= 4


def test_early_termination_1d_promotion():
    """A 1-D llrs input promotes to a batch of one (mirroring
    lte_turbo_decode)."""
    from convolutionalencdec.ops.crc import CRC24B, crc_append
    rng = np.random.default_rng(43)
    L = 40
    payload = rng.integers(0, 2, L - 24, dtype=np.uint8)
    msg = np.asarray(crc_append(CRC24B, payload))
    E = 3 * (L + 4)
    tx = np.asarray(lte.lte_turbo_encode_batch(msg[None], E))[0]
    q = ((1 - 2 * tx.astype(np.int32)) * 8).astype(np.int32)
    bits, lapp, ok, iters = lte.lte_turbo_decode_early(q, L)
    assert bits.shape == (L,) and lapp.shape == (L,) and ok.shape == ()
    assert bool(ok) and int(iters) == 1
    np.testing.assert_array_equal(np.asarray(bits), msg)
    bb, ll, bok, _ = lte.lte_turbo_decode_early(q[None], L)
    np.testing.assert_array_equal(np.asarray(bb)[0], np.asarray(bits))
    np.testing.assert_array_equal(np.asarray(ll)[0], np.asarray(lapp))
    assert bool(np.asarray(bok)[0]) == bool(ok)


def test_early_termination_unlatched_blocks_match_fixed_count():
    """Blocks that never pass their CRC decode exactly as the
    fixed-count decoder after `iters_used` iterations."""
    from convolutionalencdec.ops.crc import CRC24B, crc_append
    from convolutionalencdec.ops.turbo import turbo_decode_batch_early
    rng = np.random.default_rng(47)
    B, L = 6, 40
    payload = rng.integers(0, 2, (B, L - 24), dtype=np.uint8)
    msgs = np.asarray(crc_append(CRC24B, payload))
    tx = np.asarray(lte.lte_turbo_encode_batch(msgs, 3 * (L + 4)))
    q = ((1 - 2 * tx.astype(np.int32)) * 4).astype(np.int32)
    q = np.where(rng.random(q.shape) < 0.3, -q, q)     # hopeless channel
    fields = lte.turbo_demux_tails(lte.derate_match_turbo(
        q, L + 4, qmax=31, filler_llr=31))
    perm = tuple(int(p) for p in lte.lte_qpp(L))
    bits, lapp, ok, iters = turbo_decode_batch_early(
        RSC, *fields, perm, CRC24B, 3)
    ok = np.asarray(ok)
    assert int(iters) == 3 and not ok.all()
    wb, wl = turbo_decode_batch(RSC, *fields, perm, 3)
    np.testing.assert_array_equal(np.asarray(bits)[~ok], np.asarray(wb)[~ok])
    np.testing.assert_array_equal(np.asarray(lapp)[~ok], np.asarray(wl)[~ok])
