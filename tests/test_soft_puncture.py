"""Soft-decision metrics and puncturing tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from convolutionalencdec import (
    CodeSpec, NASA_K7, NASA_K7_R13, TOY_K3, encode_bits, viterbi_decode,
)
from convolutionalencdec.ops.channel import (
    awgn, bpsk_llr, bpsk_modulate, hard_decision, segments_to_bits,
    bits_to_segments,
)
from convolutionalencdec.ops.metrics import (
    hard_bits_to_qllrs, quantize_llrs, soft_step_metrics,
    viterbi_decode_soft, viterbi_forward_butterfly_soft,
)
from convolutionalencdec.ops.puncture import (
    PUNCTURE_2_3, PUNCTURE_3_4, depuncture_llrs, puncture_bits,
    punctured_rate, puncture_mask,
)
from convolutionalencdec.ops.viterbi import (
    hard_step_metrics, viterbi_forward, viterbi_forward_butterfly,
)


def test_soft_with_hard_llrs_equals_hard():
    """±1 pseudo-LLRs must reproduce the Hamming-metric decisions exactly."""
    spec = NASA_K7
    rng = np.random.default_rng(0)
    msg = rng.integers(0, 2, 200, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msg)[0]).copy()
    flip = rng.random(coded.shape) < 0.05
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    bits = np.asarray(segments_to_bits(coded, spec.n)).reshape(-1, spec.n)
    q = np.asarray(hard_bits_to_qllrs(bits))
    dec_soft, m_soft = viterbi_forward_butterfly_soft(spec, q)
    dec_hard, m_hard = viterbi_forward_butterfly(spec, coded)
    np.testing.assert_array_equal(np.asarray(dec_soft), np.asarray(dec_hard))
    np.testing.assert_array_equal(np.asarray(m_soft), np.asarray(m_hard))
    decoded = viterbi_decode_soft(spec, q)
    np.testing.assert_array_equal(np.asarray(decoded), msg)


def test_soft_generic_path_matches_butterfly():
    spec = NASA_K7
    rng = np.random.default_rng(1)
    msg = rng.integers(0, 2, 64, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msg)[0])
    bits = np.asarray(segments_to_bits(coded, spec.n)).reshape(-1, spec.n)
    q = rng.integers(-7, 8, bits.shape).astype(np.int32)  # random soft input
    bm = soft_step_metrics(spec, q)
    dec_g, m_g = viterbi_forward(spec, bm)
    dec_b, m_b = viterbi_forward_butterfly_soft(spec, q)
    np.testing.assert_array_equal(np.asarray(dec_g), np.asarray(dec_b))
    np.testing.assert_array_equal(np.asarray(m_g), np.asarray(m_b))


def test_soft_awgn_roundtrip_beats_hard():
    """At a marginal Eb/N0, soft decoding must fix strictly more packets
    than hard decoding over the same noise realization (the ~2 dB soft
    gain, berCurveCoded.m:46-51)."""
    spec = NASA_K7
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(7)
    B, L = 24, 512
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0])
    cbits = np.asarray(segments_to_bits(coded, spec.n))
    sym = bpsk_modulate(cbits)
    ebn0 = 2.0
    rx = awgn(key, sym, ebn0, spec.rate)
    llr = bpsk_llr(rx, ebn0, spec.rate)
    hard = np.asarray(hard_decision(llr))
    hard_segs = np.asarray(bits_to_segments(hard, spec.n))
    q = quantize_llrs(llr)
    q = np.asarray(q).reshape(B, -1, spec.n)

    soft_err = hard_err = 0
    for i in range(B):
        d_soft = np.asarray(viterbi_decode_soft(spec, q[i]))
        d_hard = np.asarray(viterbi_decode(spec, hard_segs[i]))
        soft_err += int((d_soft != msgs[i]).sum())
        hard_err += int((d_hard != msgs[i]).sum())
    assert soft_err < hard_err, (soft_err, hard_err)


def test_puncture_mask_and_rate():
    assert punctured_rate(NASA_K7, PUNCTURE_2_3) == pytest.approx(2 / 3)
    assert punctured_rate(NASA_K7, PUNCTURE_3_4) == pytest.approx(3 / 4)
    m = puncture_mask(PUNCTURE_2_3, 4)
    # step-major, generator-j-at-position-j: [g0 g1] per step; pattern
    # keeps g1 only on even steps.
    np.testing.assert_array_equal(m, [1, 1, 1, 0, 1, 1, 1, 0])


@pytest.mark.parametrize("pattern", [PUNCTURE_2_3, PUNCTURE_3_4],
                         ids=["r23", "r34"])
def test_punctured_roundtrip_noiseless(pattern):
    spec = NASA_K7
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 2, 240, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msg)[0])
    T = coded.shape[-1]
    cbits = np.asarray(segments_to_bits(coded, spec.n))
    tx = puncture_bits(cbits, pattern, T)
    # Receiver: ±1 LLRs for received bits, erasures elsewhere.
    rx_llr = 1 - 2 * np.asarray(tx).astype(np.int32)
    full = np.asarray(depuncture_llrs(rx_llr, pattern, T)).reshape(T, spec.n)
    decoded = viterbi_decode_soft(spec, full)
    np.testing.assert_array_equal(np.asarray(decoded), msg)


def test_punctured_corrects_errors():
    spec = NASA_K7
    pattern = PUNCTURE_2_3
    rng = np.random.default_rng(4)
    msg = rng.integers(0, 2, 240, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msg)[0])
    T = coded.shape[-1]
    cbits = np.asarray(segments_to_bits(coded, spec.n))
    tx = np.asarray(puncture_bits(cbits, pattern, T)).copy()
    for pos in range(7, tx.size, 120):
        tx[pos] ^= 1
    rx_llr = 1 - 2 * tx.astype(np.int32)
    full = np.asarray(depuncture_llrs(rx_llr, pattern, T)).reshape(T, spec.n)
    decoded = viterbi_decode_soft(spec, full)
    np.testing.assert_array_equal(np.asarray(decoded), msg)


def test_quantize_llrs_range_and_sign():
    llr = jnp.asarray([-100.0, -0.6, 0.0, 0.6, 100.0])
    q = np.asarray(quantize_llrs(llr, qmax=7, scale=1.0))
    np.testing.assert_array_equal(q, [-7, -1, 0, 1, 7])
    # Auto-scale stays within range and preserves signs.
    qa = np.asarray(quantize_llrs(llr, qmax=7))
    assert qa.min() >= -7 and qa.max() <= 7
    assert qa[0] < 0 < qa[-1] and qa[2] == 0


@pytest.mark.parametrize("pattern", [PUNCTURE_2_3, PUNCTURE_3_4],
                         ids=["r23", "r34"])
def test_batch_punctured_one_call(pattern):
    """One-call batched punctured decode (the core, interpreted) == the
    manual depuncture + soft-scan pipeline, and corrects sparse errors."""
    from convolutionalencdec.kernels import (
        viterbi_decode_batch_punctured,
        viterbi_decode_batch_punctured_soft)
    spec = NASA_K7
    rng = np.random.default_rng(6)
    B, L = 3, 240
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0])
    T = coded.shape[-1]
    cbits = np.asarray(segments_to_bits(coded, spec.n))
    tx = np.asarray(puncture_bits(cbits, pattern, T)).copy()
    for pos in range(7, tx.shape[-1], 160):
        tx[:, pos] ^= 1
    got = np.asarray(viterbi_decode_batch_punctured(
        spec, tx, pattern, T, interpret=True))
    # reference: per-channel scan over manually depunctured LLRs
    rx_llr = 1 - 2 * tx.astype(np.int32)
    full = np.asarray(depuncture_llrs(rx_llr, pattern, T))
    for b in range(B):
        ref = np.asarray(viterbi_decode_soft(
            spec, full[b].reshape(T, spec.n)))
        np.testing.assert_array_equal(got[b], ref)
        np.testing.assert_array_equal(got[b], msgs[b])
    # soft one-call with the same ±1 LLRs must agree
    got_s = np.asarray(viterbi_decode_batch_punctured_soft(
        spec, rx_llr.astype(np.int8), pattern, T, interpret=True))
    np.testing.assert_array_equal(got_s, got)


def test_pattern_row_count_validated():
    import pytest
    from convolutionalencdec.ops.puncture import (
        PUNCTURE_2_3, check_pattern_rows, punctured_rate)
    from convolutionalencdec.params import LTE_TBCC_K7, NASA_K7
    check_pattern_rows(NASA_K7, PUNCTURE_2_3)          # n=2: fine
    with pytest.raises(ValueError, match="rows"):
        check_pattern_rows(LTE_TBCC_K7, PUNCTURE_2_3)  # n=3: mismatch
    with pytest.raises(ValueError, match="rows"):
        punctured_rate(LTE_TBCC_K7, PUNCTURE_2_3)
