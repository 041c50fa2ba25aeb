"""Encoder tests.

Golden vectors from the reference's hand-traced unit test
(handTracedTest/handTraced.c:29-47) plus oracle cross-checks and streaming
equivalence.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from convolutionalencdec import (
    CodeSpec, NASA_K7, REF_K7, TOY_K3, K5_23_35, NASA_K7_R13, encode_bits,
    encode_bytes,
)
from convolutionalencdec.ops.bits import pack_bits, unpack_bits
from convolutionalencdec.ops.encode import encode_bits_np, encode_one_input

ALL_SPECS = [TOY_K3, NASA_K7, REF_K7, K5_23_35, NASA_K7_R13]


def test_handtraced_golden_vector():
    # handTraced.c:29-47 — encode byte 0b01101000 with K=3 g=(7,6):
    # 10 segments including S=2 zero-pad steps.
    segments = encode_bytes(TOY_K3, np.array([0b01101000], np.uint8))
    expected = [0b00, 0b11, 0b00, 0b10, 0b10, 0b11, 0b01, 0b00, 0b00, 0b00]
    np.testing.assert_array_equal(np.asarray(segments), expected)


def test_terminated_encoder_returns_to_zero():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 64, dtype=np.uint8)
    for spec in ALL_SPECS:
        _, final = encode_bits(spec, bits, terminate=True)
        assert int(final) == 0, spec


@pytest.mark.parametrize("spec", ALL_SPECS, ids=lambda s: f"K{s.K}g{s.g}")
def test_vectorized_matches_scalar_oracle(spec):
    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, 120 * spec.k, dtype=np.uint8)
    got, final = encode_bits(spec, bits, terminate=True)
    want = encode_bits_np(spec, bits, terminate=True)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert int(final) == 0


def test_unterminated_final_state_feeds_next_chunk():
    """Chunked streaming: encoding in two chunks with carried state equals
    one-shot encoding (the reference's convEnc chunk/carry-over seam,
    convEncode.c:46-130)."""
    rng = np.random.default_rng(7)
    for spec in ALL_SPECS:
        bits = rng.integers(0, 2, 80 * spec.k, dtype=np.uint8)
        seg_a, state = encode_bits(spec, bits[:40 * spec.k], terminate=False)
        seg_b, final = encode_bits(spec, bits[40 * spec.k:], terminate=True,
                                   initial_state=state)
        chunked = np.concatenate([np.asarray(seg_a), np.asarray(seg_b)])
        oneshot, _ = encode_bits(spec, bits, terminate=True)
        np.testing.assert_array_equal(chunked, np.asarray(oneshot))
        assert int(final) == 0


def test_batched_encode():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (5, 64), dtype=np.uint8)
    batched, _ = encode_bits(NASA_K7, bits)
    for i in range(5):
        single, _ = encode_bits(NASA_K7, bits[i])
        np.testing.assert_array_equal(np.asarray(batched[i]),
                                      np.asarray(single))


def test_encode_one_input_matches_shift_register():
    for spec in ALL_SPECS:
        rng = np.random.default_rng(1)
        state = 0
        for _ in range(50):
            u = int(rng.integers(0, spec.num_edges_per_state))
            seg, state2 = encode_one_input(spec, state, u)
            # Oracle: unroll through encode_bits_np with initial_state.
            ubits = [(u >> (spec.k - 1 - j)) & 1 for j in range(spec.k)]
            want = encode_bits_np(spec, np.array(ubits, np.uint8),
                                  terminate=False, initial_state=state)
            assert seg == want[0]
            state = state2


def test_bit_pack_roundtrip():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (3, 16), dtype=np.uint8)
    bits = unpack_bits(data)
    back = pack_bits(bits)
    np.testing.assert_array_equal(np.asarray(back), data)
    # MSb-first: byte 0b10000001 -> bits [1,0,0,0,0,0,0,1]
    np.testing.assert_array_equal(
        np.asarray(unpack_bits(np.array([0b10000001], np.uint8))),
        [1, 0, 0, 0, 0, 0, 0, 1])


def test_codespec_validation():
    with pytest.raises(ValueError):
        CodeSpec(K=7, g=(0o133, 0o171), starting_state=1)
    with pytest.raises(ValueError):
        CodeSpec(K=1, g=(1,))
    with pytest.raises(ValueError):
        CodeSpec(K=3, g=(0b1111,))  # does not fit in K bits
    assert NASA_K7.has_poly_symmetry
    assert REF_K7.has_poly_symmetry
    # TOY_K3 g[1]=0b110 lacks the newest-bit tap -> no symmetry
    # (viterbiDecoder.c:20-25; SURVEY.md §4 caveat).
    assert not TOY_K3.has_poly_symmetry
    assert NASA_K7.num_states == 64
    assert NASA_K7.rate == 0.5
    assert NASA_K7.traceback_len == 35
