"""Viterbi decoder tests.

White-box trellis stepping and golden vectors from
handTracedTest/handTraced.c:49-115, generic-vs-butterfly cross-checks
(SURVEY.md §4 recommends keeping this as an explicit test), and roundtrip /
error-correction properties.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from convolutionalencdec import (
    NASA_K7, NASA_K7_R13, REF_K7, TOY_K3, K5_23_35,
    encode_bits, encode_bytes,
    viterbi_decode, viterbi_decode_stream, viterbi_forward,
    viterbi_forward_butterfly, traceback_terminated,
)
from convolutionalencdec.ops.bits import pack_bits
from convolutionalencdec.ops.viterbi import hard_step_metrics

# handTraced.c:55 — encoded 0x68 with 2 injected bit errors (segments 0, 2).
CORRUPTED = np.array([0b01, 0b11, 0b01, 0b10, 0b10, 0b11, 0b01, 0b00,
                      0b00, 0b00], np.uint8)


def test_handtraced_decode_corrects_two_errors():
    bits = viterbi_decode(TOY_K3, CORRUPTED)
    byte = int(np.asarray(pack_bits(bits))[0])
    assert byte == 0b01101000, f"got {byte:#010b}"


def test_handtraced_stepwise_metrics():
    """The exact path-metric vectors after each of the first 4 trellis steps
    (handTraced.c:72-115), including the reset invariants (state 0 = 0,
    others = num_states + 1 = 5)."""
    bm = hard_step_metrics(TOY_K3, CORRUPTED[:4])
    _, _, history = viterbi_forward(TOY_K3, bm, collect_metrics=True)
    history = np.asarray(history)
    np.testing.assert_array_equal(history[0], [1, 1, 6, 5])
    np.testing.assert_array_equal(history[1], [3, 1, 1, 3])
    np.testing.assert_array_equal(history[2], [1, 3, 2, 2])
    np.testing.assert_array_equal(history[3], [2, 2, 2, 4])


@pytest.mark.parametrize("spec", [NASA_K7, REF_K7],
                         ids=lambda s: f"g{s.g}")
def test_butterfly_matches_generic(spec):
    """The k=1 poly-symmetry butterfly must produce decisions bit-identical
    to the generic decoder (both tie-break toward the low source)."""
    rng = np.random.default_rng(11)
    msg = rng.integers(0, 2, 256, dtype=np.uint8)
    coded, _ = encode_bits(spec, msg)
    # Inject noise well beyond the correction limit — decisions must STILL
    # be identical (this is an implementation-equivalence test, not a BER
    # test).
    noisy = np.asarray(coded).copy()
    flip = rng.random(noisy.shape) < 0.10
    noisy = noisy ^ (flip.astype(np.uint8) * rng.integers(1, 4, noisy.shape).astype(np.uint8))
    bm = hard_step_metrics(spec, noisy)
    dec_g, m_g = viterbi_forward(spec, bm)
    dec_b, m_b = viterbi_forward_butterfly(spec, noisy)
    np.testing.assert_array_equal(np.asarray(dec_g), np.asarray(dec_b))
    np.testing.assert_array_equal(np.asarray(m_g), np.asarray(m_b))


@pytest.mark.parametrize("spec", [TOY_K3, NASA_K7, K5_23_35, NASA_K7_R13],
                         ids=lambda s: f"K{s.K}n{s.n}")
def test_noiseless_roundtrip(spec):
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 2, 128 * spec.k, dtype=np.uint8)
    coded, _ = encode_bits(spec, msg)
    decoded = viterbi_decode(spec, coded)
    np.testing.assert_array_equal(np.asarray(decoded), msg)


def test_corrects_scattered_errors_k7():
    """K=7 (133,171) has free distance 10 — scattered single-bit flips far
    apart must all be corrected."""
    rng = np.random.default_rng(17)
    msg = rng.integers(0, 2, 512, dtype=np.uint8)
    coded = np.asarray(encode_bits(NASA_K7, msg)[0]).copy()
    for pos in range(10, 500, 50):  # flip one coded bit every 50 segments
        coded[pos] ^= 1
    decoded = viterbi_decode(NASA_K7, coded)
    np.testing.assert_array_equal(np.asarray(decoded), msg)


def test_streaming_matches_block_on_clean_channel():
    rng = np.random.default_rng(23)
    msg = rng.integers(0, 2, 256, dtype=np.uint8)
    coded, _ = encode_bits(NASA_K7, msg)
    blk = viterbi_decode(NASA_K7, coded)
    stm = viterbi_decode_stream(NASA_K7, coded)
    np.testing.assert_array_equal(np.asarray(blk), msg)
    np.testing.assert_array_equal(np.asarray(stm), msg)


def test_streaming_corrects_errors():
    rng = np.random.default_rng(29)
    msg = rng.integers(0, 2, 512, dtype=np.uint8)
    coded = np.asarray(encode_bits(NASA_K7, msg)[0]).copy()
    for pos in range(5, coded.size, 97):
        coded[pos] ^= 1
    stm = viterbi_decode_stream(NASA_K7, coded)
    np.testing.assert_array_equal(np.asarray(stm), msg)


def test_batched_decode_vmap():
    rng = np.random.default_rng(31)
    msgs = rng.integers(0, 2, (8, 128), dtype=np.uint8)
    coded, _ = encode_bits(NASA_K7, msgs)
    decoded = jax.vmap(lambda c: viterbi_decode(NASA_K7, c))(coded)
    np.testing.assert_array_equal(np.asarray(decoded), msgs)


def test_generic_k2_code_roundtrip():
    """Exercise k=2 (the generic decoder path the butterfly can't take).
    A k=2 rate-2/3 code: 4 edges per state."""
    from convolutionalencdec import CodeSpec
    spec = CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13))
    rng = np.random.default_rng(37)
    msg = rng.integers(0, 2, 64, dtype=np.uint8)
    coded, _ = encode_bits(spec, msg)
    decoded = viterbi_decode(spec, coded)
    np.testing.assert_array_equal(np.asarray(decoded), msg)
