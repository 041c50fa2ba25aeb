"""Byte-level decode API: packed output, streaming partial-byte carry,
and the 8 % k != 0 spillover (viterbiDecoder.c:152-189,
convEncode.h:36-37)."""

import numpy as np
import pytest

from convolutionalencdec import (
    NASA_K7, encode_bits, encode_bytes, viterbi_decode,
    viterbi_decode_bytes,
)
from convolutionalencdec.params import CodeSpec
from convolutionalencdec.ops.bits import pack_bits_np, unpack_bits_np

#: k=3 rate-3/4 code: 8 % k != 0, so decoded symbols straddle byte
#: boundaries (the reference's spillover case).
K3_SPILL = CodeSpec(K=2, k=3, g=(0o77, 0o65, 0o57, 0o73))


def test_decode_bytes_roundtrip_k7():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 32, dtype=np.uint8)
    coded = np.asarray(encode_bytes(NASA_K7, data))
    got = np.asarray(viterbi_decode_bytes(NASA_K7, coded))
    np.testing.assert_array_equal(got, data)


def test_decode_bytes_partial_tail():
    """Non-multiple-of-8 message: trailing byte zero-padded MSb-first."""
    rng = np.random.default_rng(4)
    L = 61
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    coded = np.asarray(encode_bits(NASA_K7, bits)[0])
    got = np.asarray(viterbi_decode_bytes(NASA_K7, coded, L))
    want = pack_bits_np(np.pad(bits, (0, 3)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8,)


def test_decode_bytes_k3_spillover_roundtrip():
    """k=3: symbols straddle byte boundaries; byte output must equal the
    packed bit output bit-for-bit."""
    rng = np.random.default_rng(5)
    L = 96                              # multiple of k=3 and of 8
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    coded = np.asarray(encode_bits(K3_SPILL, bits)[0])
    got = np.asarray(viterbi_decode_bytes(K3_SPILL, coded, L))
    dec_bits = np.asarray(viterbi_decode(K3_SPILL, coded))[:L]
    np.testing.assert_array_equal(got, pack_bits_np(dec_bits))
    np.testing.assert_array_equal(dec_bits, bits)


def test_streaming_decode_bytes_carry_k3():
    """Chunked byte-granular streaming with k=3: partial bytes carry
    across chunk seams (remainingUncoded's decode-side twin) and the
    total equals the one-shot byte decode."""
    from convolutionalencdec.ops.streaming import StreamingDecoder
    from convolutionalencdec.ops.viterbi import viterbi_decode_stream
    spec = K3_SPILL
    rng = np.random.default_rng(6)
    L = 120                             # 40 symbols, 15 bytes
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, bits)[0])
    dec = StreamingDecoder(spec)
    outs = []
    cuts = [7, 19, coded.shape[0]]      # ragged seams
    prev = 0
    for c in cuts:
        outs.append(dec.decode_bytes(coded[prev:c], last=(c == cuts[-1])))
        prev = c
    got = np.concatenate(outs)
    want_bits = np.asarray(viterbi_decode_stream(spec, coded))
    np.testing.assert_array_equal(got, pack_bits_np(want_bits))
    # mid-stream chunks emit only COMPLETE bytes: after consuming t
    # segments the stream has emitted (t - W)*k bits (W-step decode
    # delay), and the byte API must hold back the partial byte — so the
    # non-last chunks together emit exactly floor(emitted_bits / 8)
    # bytes, not a zero-padded partial.
    emitted_bits = max(0, cuts[-2] - spec.traceback_len) * spec.k
    assert sum(o.size for o in outs[:-1]) == emitted_bits // 8
    assert all(o.dtype == np.uint8 for o in outs)


def test_streaming_decode_bytes_batch_k7():
    from convolutionalencdec.ops.streaming import StreamingDecoderBatch
    from convolutionalencdec.ops.viterbi import viterbi_decode_stream
    spec = NASA_K7
    rng = np.random.default_rng(7)
    B, L = 4, 250
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0])
    dec = StreamingDecoderBatch(spec, batch=B)
    a = dec.decode_bytes(coded[:, :96])
    b = dec.decode_bytes(coded[:, 96:], last=True)
    got = np.concatenate([a, b], axis=1)
    want = np.stack([
        pack_bits_np(np.pad(np.asarray(viterbi_decode_stream(spec, coded[i])),
                            (0, (-L) % 8))) for i in range(B)])
    np.testing.assert_array_equal(got, want)


def test_decode_batch_bytes_swar_fast_path():
    """The core's byte emit (MSb-first from the traceback) must equal
    pack_bits of the bit decode, including the zero-padded partial
    trailing byte."""
    from convolutionalencdec.kernels import (
        viterbi_decode_batch, viterbi_decode_batch_bytes)
    rng = np.random.default_rng(9)
    B, L = 3, 93                        # L % 8 == 5: partial tail
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(NASA_K7, msgs)[0]).copy()
    flip = rng.random(coded.shape) < 0.02
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    got = np.asarray(viterbi_decode_batch_bytes(NASA_K7, coded, L,
                                                interpret=True))
    bits = np.asarray(viterbi_decode_batch(NASA_K7, coded, L,
                                           interpret=True))
    want = np.stack([pack_bits_np(np.pad(bits[i], (0, (-L) % 8)))
                     for i in range(B)])
    np.testing.assert_array_equal(got, want)
    assert got.shape == (B, (L + 7) // 8)


@pytest.mark.parametrize("qmax", [7, 31])
def test_decode_batch_soft_bytes_fast_paths(qmax):
    """Soft byte emit (LLR magnitudes up to 7 or 31) must equal
    pack_bits of the soft bit decode, incl. the partial tail."""
    from convolutionalencdec.kernels import (
        viterbi_decode_batch_soft, viterbi_decode_batch_soft_bytes)
    rng = np.random.default_rng(11)
    B, L = 3, 93                        # L % 8 == 5: partial tail
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(NASA_K7, msgs)[0])
    q = np.zeros((B, coded.shape[1], NASA_K7.n), np.int32)
    for j in range(NASA_K7.n):
        q[..., j] = 1 - 2 * ((coded >> j) & 1).astype(np.int32)
    q *= rng.integers(1, qmax + 1, q.shape)
    flip = rng.random(q.shape) < 0.04
    q = np.where(flip, -q, q)
    got = np.asarray(viterbi_decode_batch_soft_bytes(
        NASA_K7, q, L, interpret=True))
    bits = np.asarray(viterbi_decode_batch_soft(
        NASA_K7, q, L, interpret=True))
    want = np.stack([pack_bits_np(np.pad(bits[i], (0, (-L) % 8)))
                     for i in range(B)])
    np.testing.assert_array_equal(got, want)
    assert got.shape == (B, (L + 7) // 8)


def test_decode_bytes_matches_oracle():
    """Byte output against the independent C++ oracle."""
    from convolutionalencdec.native import oracle_decode
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, 16, dtype=np.uint8)
    coded = np.asarray(encode_bytes(NASA_K7, data)).copy()
    flip = rng.random(coded.shape) < 0.02
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    got = np.asarray(viterbi_decode_bytes(NASA_K7, coded))
    want_bits = np.asarray(oracle_decode(NASA_K7, coded))[:128]
    np.testing.assert_array_equal(got, pack_bits_np(want_bits))
