"""Tail-biting codes: encode circularity, wrap decode against the ML
oracle, soft/hard agreement.

Beyond-reference extension (the reference terminates every packet,
convEncode.c:101-122); the wrap decode reuses the reference's
traceback-truncation argument (viterbiDecoder.c:53-74) circularly.
"""

import numpy as np
import pytest

import jax

from convolutionalencdec import (
    LTE_TBCC_K7, NASA_K7, TOY_K3, CodeSpec,
)
from convolutionalencdec.ops.encode import encode_one_input
from convolutionalencdec.ops.metrics import hard_bits_to_qllrs
from convolutionalencdec.ops.tailbiting import (
    encode_tailbiting, tail_state, viterbi_decode_tailbiting,
    viterbi_decode_tailbiting_exact, viterbi_decode_tailbiting_soft,
)


def _encode_tb_oracle(spec, bits):
    """Host-int tail-biting encoder via single trellis steps."""
    kS = spec.k * spec.S
    state = 0
    for b in bits[-kS:]:
        state = ((state << 1) | int(b)) & (spec.num_states - 1)
    start = state
    segs = []
    for t in range(0, len(bits), spec.k):
        u = 0
        for b in bits[t:t + spec.k]:
            u = (u << 1) | int(b)
        seg, state = encode_one_input(spec, state, u)
        segs.append(seg)
    assert state == start, "tail-biting path must close"
    return np.asarray(segs, np.uint8)


@pytest.mark.parametrize("spec", [TOY_K3, NASA_K7, LTE_TBCC_K7],
                         ids=lambda s: f"K{s.K}n{s.n}")
def test_encode_tailbiting_is_circular(spec):
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 64, dtype=np.uint8)
    segs = np.asarray(encode_tailbiting(spec, bits))
    np.testing.assert_array_equal(segs, _encode_tb_oracle(spec, bits))
    # Re-encoding from the decoder's perspective: initial state == final.
    from convolutionalencdec.ops.encode import encode_bits
    seg2, final = encode_bits(spec, bits, terminate=False,
                              initial_state=tail_state(spec, bits))
    assert int(final) == int(tail_state(spec, bits))
    np.testing.assert_array_equal(segs, np.asarray(seg2))


def test_encode_tailbiting_k2():
    spec = CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13))
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, 48, dtype=np.uint8)
    segs = np.asarray(encode_tailbiting(spec, bits))
    assert segs.shape == (24,)  # rate exactly k/n: no termination steps


def test_exact_decoder_recovers_clean_and_corrects():
    rng = np.random.default_rng(11)
    for _ in range(8):
        bits = rng.integers(0, 2, 40, dtype=np.uint8)
        segs = np.asarray(encode_tailbiting(TOY_K3, bits))
        got = np.asarray(viterbi_decode_tailbiting_exact(TOY_K3, segs))
        np.testing.assert_array_equal(got, bits)
        # one injected symbol error anywhere must still decode
        bad = segs.copy()
        pos = rng.integers(0, len(segs))
        bad[pos] ^= rng.integers(1, 4)
        got = np.asarray(viterbi_decode_tailbiting_exact(TOY_K3, bad))
        np.testing.assert_array_equal(got, bits)


def test_wrap_decode_matches_exact():
    """The circular wrap decode equals the ML oracle on clean packets and
    agrees near-everywhere under in-spec noise (survivors merge within
    the wrap — the truncation argument, viterbiDecoder.c:53-74)."""
    rng = np.random.default_rng(13)
    agree = total = 0
    for _ in range(30):
        bits = rng.integers(0, 2, 96, dtype=np.uint8)
        segs = np.asarray(encode_tailbiting(TOY_K3, bits))
        clean = np.asarray(viterbi_decode_tailbiting(TOY_K3, segs))
        np.testing.assert_array_equal(clean, bits)
        flip = rng.random(segs.shape) < 0.02
        noisy = segs ^ (flip * rng.integers(1, 4, segs.shape)).astype(np.uint8)
        ml = np.asarray(viterbi_decode_tailbiting_exact(TOY_K3, noisy))
        wd = np.asarray(viterbi_decode_tailbiting(TOY_K3, noisy))
        agree += int(np.sum(ml == wd))
        total += ml.size
    assert agree / total > 0.99


def test_wrap_decode_generic_k():
    """k=2 codes ride the generic scan path; clean round-trip."""
    spec = CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13))
    rng = np.random.default_rng(17)
    bits = rng.integers(0, 2, 80, dtype=np.uint8)
    segs = np.asarray(encode_tailbiting(spec, bits))
    got = np.asarray(viterbi_decode_tailbiting(spec, segs))
    np.testing.assert_array_equal(got, bits)


def test_soft_wrap_decode_matches_hard():
    """Hard bits mapped to q = 1-2b give Hamming-equivalent costs, so the
    soft wrap decode is decision-identical to the hard one."""
    rng = np.random.default_rng(19)
    bits = rng.integers(0, 2, 120, dtype=np.uint8)
    segs = np.asarray(encode_tailbiting(NASA_K7, bits))
    flip = rng.random(segs.shape) < 0.04
    noisy = segs ^ (flip * rng.integers(1, 4, segs.shape)).astype(np.uint8)
    hard = np.asarray(viterbi_decode_tailbiting(NASA_K7, noisy))
    seg_bits = np.stack([(noisy >> j) & 1 for j in range(NASA_K7.n)], axis=-1)
    q = hard_bits_to_qllrs(seg_bits)
    soft = np.asarray(viterbi_decode_tailbiting_soft(NASA_K7, q))
    np.testing.assert_array_equal(soft, hard)


@pytest.mark.parametrize("spec", [NASA_K7, LTE_TBCC_K7],
                         ids=lambda s: f"K{s.K}n{s.n}")
def test_kernel_tailbiting_matches_scan(spec):
    """Batched circular wrap decode agrees with the ML oracle
    (`viterbi_decode_tailbiting_exact`) under in-spec noise and
    recovers the messages."""
    rng = np.random.default_rng(23)
    B, L = 3, 150
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_tailbiting(spec, msgs))
    flip = rng.random(coded.shape) < 0.03
    coded = coded ^ (flip * rng.integers(
        1, 2 ** spec.n, coded.shape)).astype(np.uint8)
    got = np.asarray(jax.vmap(
        lambda c: viterbi_decode_tailbiting(spec, c))(coded))
    ml = np.stack([np.asarray(viterbi_decode_tailbiting_exact(spec, c))
                   for c in coded])
    assert np.mean(got == ml) > 0.99
    assert np.mean(got == msgs) > 0.99


def test_kernel_tailbiting_short_packet_mod_wrap():
    """Packets shorter than the wrap exercise the mod-indexed circular
    extension."""
    rng = np.random.default_rng(29)
    B, L = 2, 40   # < default wrap (42)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_tailbiting(NASA_K7, msgs))
    got = np.asarray(jax.vmap(
        lambda c: viterbi_decode_tailbiting(NASA_K7, c))(coded))
    np.testing.assert_array_equal(got, msgs)


@pytest.mark.parametrize("qmax", [7, 31], ids=["swar8", "swar16"])
def test_kernel_tailbiting_soft_matches_scan(qmax):
    """Scaled pseudo-LLRs (scale 1 or 9) give the soft wrap decode the
    hard wrap decode's decisions, and recover the messages."""
    rng = np.random.default_rng(37)
    B, L = 3, 150
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_tailbiting(NASA_K7, msgs))
    flip = rng.random(coded.shape) < 0.03
    coded = coded ^ (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    seg_bits = np.stack([(coded >> j) & 1 for j in range(NASA_K7.n)],
                        axis=-1)
    scale = 1 if qmax == 7 else 9
    q = (scale * np.asarray(hard_bits_to_qllrs(seg_bits))).astype(np.int8)
    ref = np.asarray(jax.vmap(
        lambda c: viterbi_decode_tailbiting(NASA_K7, c))(coded))
    got = np.asarray(jax.vmap(
        lambda c: viterbi_decode_tailbiting_soft(NASA_K7, c))(q))
    np.testing.assert_array_equal(got, ref)
    assert np.mean(got == msgs) > 0.99


def test_list_size_validated_scan_twins():
    import pytest
    from convolutionalencdec.ops.tailbiting import (
        viterbi_decode_tailbiting_list, viterbi_decode_tailbiting_list_soft)
    segs = np.zeros((48,), np.uint8)
    with pytest.raises(ValueError, match="list_size"):
        viterbi_decode_tailbiting_list(NASA_K7, segs, list_size=100)
    q = np.zeros((48, 2), np.int32)
    with pytest.raises(ValueError, match="list_size"):
        viterbi_decode_tailbiting_list_soft(NASA_K7, q, list_size=0)


def test_exact_oracle_rejects_oversized_packets():
    import pytest
    from convolutionalencdec.ops.tailbiting import (
        viterbi_decode_tailbiting_exact)
    segs = np.zeros((1 << 19,), np.uint8)      # T*n = 2^20: at the bound
    with pytest.raises(ValueError, match="exclusion"):
        viterbi_decode_tailbiting_exact(NASA_K7, segs)
