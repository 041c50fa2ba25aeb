"""Cross-validation against the independent C++ oracle codec.

The JAX/Pallas path and the C++ oracle share only the CodeSpec conventions
— different languages, different formulations (vectorized convolution vs
shift register; scan ACS vs nested loops) — so agreement here is strong
evidence both are right (the MATLAB-oracle pattern, SURVEY.md §4 item 4).
"""

import numpy as np
import pytest

from convolutionalencdec import (
    CodeSpec, K5_23_35, NASA_K7, NASA_K7_R13, REF_K7, TOY_K3,
    encode_bits, viterbi_decode,
)
from convolutionalencdec.native import oracle_decode, oracle_encode

SPECS = [TOY_K3, NASA_K7, REF_K7, K5_23_35, NASA_K7_R13,
         CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13))]
IDS = [f"K{s.K}k{s.k}n{s.n}" for s in SPECS]


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_encode_matches_oracle(spec):
    rng = np.random.default_rng(21)
    bits = rng.integers(0, 2, 96 * spec.k, dtype=np.uint8)
    jax_segs = np.asarray(encode_bits(spec, bits)[0])
    cpp_segs = oracle_encode(spec, bits)
    np.testing.assert_array_equal(jax_segs, cpp_segs)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_decode_matches_oracle(spec):
    rng = np.random.default_rng(22)
    bits = rng.integers(0, 2, 96 * spec.k, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, bits)[0]).copy()
    flip = rng.random(coded.shape) < 0.04
    coded ^= (flip * rng.integers(1, 1 << spec.n, coded.shape)).astype(
        np.uint8)
    jax_bits = np.asarray(viterbi_decode(spec, coded))
    cpp_bits = oracle_decode(spec, coded)
    np.testing.assert_array_equal(jax_bits, cpp_bits)
