"""Max-log-MAP soft-output decoding: exact integer LLRs checked against
brute-force path enumeration (every possible message), plus consistency
with the Viterbi decoders.  Beyond-reference capability (the reference
emits hard decisions only, viterbiDecoder.c:52-234)."""

import numpy as np
import pytest

from convolutionalencdec import NASA_K7, TOY_K3, encode_bits
from convolutionalencdec.params import CodeSpec
from convolutionalencdec.ops.maxlogmap import (
    maxlogmap_decode, maxlogmap_llrs, maxlogmap_llrs_batch)

K2_RATE23 = CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13))


def _brute_force_llrs(spec, qllrs):
    """Enumerate all messages; cost(msg) = sum soft branch costs of its
    path; LLR_t = min cost among msgs with bit t = 1 minus bit t = 0."""
    T, n = qllrs.shape
    L = (T - spec.S) * spec.k
    msgs = ((np.arange(1 << L)[:, None] >> np.arange(L - 1, -1, -1)) & 1) \
        .astype(np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0])      # [2^L, T]
    cost = np.zeros(1 << L, np.int64)
    for j in range(n):
        bit_j = (coded >> j) & 1
        q = qllrs[:, j][None, :]
        cost += np.where(bit_j == 1, np.maximum(q, 0),
                         np.maximum(-q, 0)).sum(axis=1)
    llrs = np.zeros(L, np.int64)
    for t in range(L):
        one = msgs[:, t] == 1
        llrs[t] = cost[one].min() - cost[~one].min()
    return llrs


@pytest.mark.parametrize("spec,L,seed", [(TOY_K3, 10, 0),
                                         (K2_RATE23, 10, 1)])
def test_maxlogmap_exact_vs_brute_force(spec, L, seed):
    rng = np.random.default_rng(seed)
    T = L // spec.k + spec.S
    q = rng.integers(-7, 8, size=(T, spec.n)).astype(np.int32)
    got = np.asarray(maxlogmap_llrs(spec, q))[:L]
    want = _brute_force_llrs(spec, q)
    np.testing.assert_array_equal(got, want)


def test_maxlogmap_decode_clean_input():
    """Strong correct LLRs decode the message; LLR signs match."""
    rng = np.random.default_rng(5)
    L = 64
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    coded = np.asarray(encode_bits(NASA_K7, bits)[0])
    q = np.zeros((coded.shape[0], NASA_K7.n), np.int32)
    for j in range(NASA_K7.n):
        q[:, j] = (1 - 2 * ((coded >> j) & 1).astype(np.int32)) * 7
    got = np.asarray(maxlogmap_decode(NASA_K7, q))
    np.testing.assert_array_equal(got, bits)
    llrs = np.asarray(maxlogmap_llrs(NASA_K7, q))[:L]
    # Reliabilities are symmetric around 0 with the right signs.
    np.testing.assert_array_equal(llrs < 0, bits == 1)


def test_maxlogmap_noisy_agrees_with_viterbi_mostly():
    """Bitwise MAP and sequence ML agree except possibly at near-ties;
    on moderate noise they should coincide on > 99% of bits and both
    recover the message."""
    from convolutionalencdec.ops.metrics import viterbi_decode_soft
    rng = np.random.default_rng(11)
    L = 256
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    coded = np.asarray(encode_bits(NASA_K7, bits)[0])
    q = np.zeros((coded.shape[0], NASA_K7.n), np.int32)
    for j in range(NASA_K7.n):
        q[:, j] = 1 - 2 * ((coded >> j) & 1).astype(np.int32)
    q *= rng.integers(2, 8, q.shape)
    flip = rng.random(q.shape) < 0.03
    q = np.where(flip, -q, q)
    map_bits = np.asarray(maxlogmap_decode(NASA_K7, q))
    vit_bits = np.asarray(viterbi_decode_soft(NASA_K7, q))
    assert (map_bits != vit_bits).mean() < 0.01
    np.testing.assert_array_equal(map_bits, bits)


def test_maxlogmap_batch_shape():
    rng = np.random.default_rng(13)
    B, L = 3, 40
    T = L + TOY_K3.S
    q = rng.integers(-7, 8, size=(B, T, TOY_K3.n)).astype(np.int32)
    out = np.asarray(maxlogmap_llrs_batch(TOY_K3, q))
    assert out.shape == (B, T)
    for b in range(B):
        np.testing.assert_array_equal(
            out[b], np.asarray(maxlogmap_llrs(TOY_K3, q[b])))


def test_maxlogmap_erasures_zero_llr():
    """An all-erasure channel (q = 0) gives LLR 0 on every message bit
    (no evidence, and termination bias must not leak into them)."""
    T = 20 + TOY_K3.S
    q = np.zeros((T, TOY_K3.n), np.int32)
    llrs = np.asarray(maxlogmap_llrs(TOY_K3, q))[:20]
    np.testing.assert_array_equal(llrs, 0)


def test_maxlogmap_decode_unterminated_keeps_all_bits():
    """terminated=False has no termination steps to strip: all T*k
    positions are message bits."""
    from convolutionalencdec.ops.metrics import hard_bits_to_qllrs

    rng = np.random.default_rng(3)
    msgs = rng.integers(0, 2, 96, dtype=np.uint8)
    coded, _ = encode_bits(NASA_K7, msgs, terminate=False)
    from convolutionalencdec.ops.channel import segments_to_bits
    q = np.asarray(hard_bits_to_qllrs(
        np.asarray(segments_to_bits(coded, NASA_K7.n)))).reshape(
            -1, NASA_K7.n).astype(np.int8)
    out = np.asarray(maxlogmap_decode(NASA_K7, q, terminated=False))
    assert out.shape == (96,)
    np.testing.assert_array_equal(out, msgs)   # clean channel


def test_kernel_rejects_wrong_plane_count():
    import pytest
    q = np.zeros((2, 48, 4), np.int8)          # spec.n == 2
    with pytest.raises(ValueError, match="last dim"):
        maxlogmap_llrs_batch(NASA_K7, q)


def test_int8_minus128_saturates_not_wraps():
    """q = -128 is out of the quantizer contract; the batched entry
    floors it to -127 (saturating metric)."""
    rng = np.random.default_rng(3)
    q = rng.integers(-7, 8, (1, 48, 2)).astype(np.int8)
    q[0, 5, 0] = -128
    got = np.asarray(maxlogmap_llrs_batch(NASA_K7, q))[0]
    want = np.asarray(maxlogmap_llrs(
        NASA_K7, np.maximum(q[0].astype(np.int32), -127)))
    L = 48 - NASA_K7.S       # message bits; termination steps saturate
    np.testing.assert_array_equal(got[:L], want[:L])
