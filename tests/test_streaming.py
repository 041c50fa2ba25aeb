"""Chunked streaming API tests — chunk/carry-over equivalence, the
reference's convEnc / viterbiDecoderHard seam (SURVEY.md §5)."""

import numpy as np
import pytest

from convolutionalencdec import (
    NASA_K7, encode_bits, viterbi_decode_stream,
)
from convolutionalencdec.ops.streaming import (
    StreamingDecoder, StreamingEncoder,
)


def test_streaming_encoder_chunks_equal_oneshot():
    spec = NASA_K7
    rng = np.random.default_rng(41)
    bits = rng.integers(0, 2, 300, dtype=np.uint8)
    enc = StreamingEncoder(spec)
    parts = [enc.encode(bits[:100]), enc.encode(bits[100:140]),
             enc.encode(bits[140:], last=True)]
    chunked = np.concatenate(parts)
    oneshot = np.asarray(encode_bits(spec, bits, terminate=True)[0])
    np.testing.assert_array_equal(chunked, oneshot)
    # Encoder auto-reset: a second packet starts from state 0.
    again = enc.encode(bits, last=True)
    np.testing.assert_array_equal(again, oneshot)


def test_streaming_decoder_chunks_equal_oneshot():
    spec = NASA_K7
    rng = np.random.default_rng(43)
    msg = rng.integers(0, 2, 512, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msg)[0]).copy()
    for pos in range(3, coded.size, 71):
        coded[pos] ^= 1
    oneshot = np.asarray(viterbi_decode_stream(spec, coded))

    dec = StreamingDecoder(spec)
    parts = [dec.decode(coded[:200]), dec.decode(coded[200:300]),
             dec.decode(coded[300:], last=True)]
    chunked = np.concatenate(parts)
    np.testing.assert_array_equal(chunked, oneshot)
    np.testing.assert_array_equal(chunked, msg)


def test_streaming_decoder_two_packets():
    spec = NASA_K7
    rng = np.random.default_rng(47)
    dec = StreamingDecoder(spec)
    for _ in range(2):
        msg = rng.integers(0, 2, 256, dtype=np.uint8)
        coded = np.asarray(encode_bits(spec, msg)[0])
        out = dec.decode(coded, last=True)
        np.testing.assert_array_equal(out, msg)


def test_streaming_batch_kernel_matches_scan_stream():
    """StreamingDecoderBatch is bit-identical to per-packet
    viterbi_decode_stream across ragged chunk boundaries — the
    reference's streaming emit, batched (viterbiDecoder.c:122-190)."""
    from convolutionalencdec.ops.streaming import StreamingDecoderBatch
    from convolutionalencdec.ops.viterbi import viterbi_decode_stream
    spec = NASA_K7
    rng = np.random.default_rng(23)
    B, L = 8, 250                    # T = 256
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < 0.02
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)

    dec = StreamingDecoderBatch(spec, batch=B)
    # ragged chunks
    cuts = [96, 149, coded.shape[1]]
    out, prev = [], 0
    for c in cuts:
        out.append(dec.decode(coded[:, prev:c], last=(c == cuts[-1])))
        prev = c
    got = np.concatenate(out, axis=1)

    want = np.stack([np.asarray(viterbi_decode_stream(spec, coded[b]))
                     for b in range(B)])
    np.testing.assert_array_equal(got, want)
    # sliding-window decode corrects the 2% noise away from the seams
    assert (got != msgs).mean() < 5e-2


def test_stream_soft_scan_matches_hard_on_pseudo_llrs():
    """viterbi_decode_stream_soft on ±1 pseudo-LLRs must equal the hard
    streaming decoder (the soft cost reduces to Hamming), and scaled
    LLRs must decode the message."""
    from convolutionalencdec.ops.viterbi import (
        viterbi_decode_stream, viterbi_decode_stream_soft)
    spec = NASA_K7
    rng = np.random.default_rng(31)
    L = 200
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, bits)[0]).copy()
    flip = rng.random(coded.shape) < 0.03
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    q = np.zeros((coded.shape[0], spec.n), np.int32)
    for j in range(spec.n):
        q[:, j] = 1 - 2 * ((coded >> j) & 1).astype(np.int32)
    hard = np.asarray(viterbi_decode_stream(spec, coded))
    soft = np.asarray(viterbi_decode_stream_soft(spec, q))
    np.testing.assert_array_equal(hard, soft)
    soft5 = np.asarray(viterbi_decode_stream_soft(spec, q * 5))
    np.testing.assert_array_equal(soft5, bits)


def test_streaming_batch_soft_kernel_matches_scan_stream():
    """Soft StreamingDecoderBatch is bit-identical to per-packet
    viterbi_decode_stream_soft across ragged chunk seams."""
    from convolutionalencdec.ops.streaming import StreamingDecoderBatch
    from convolutionalencdec.ops.viterbi import viterbi_decode_stream_soft
    spec = NASA_K7
    rng = np.random.default_rng(37)
    B, L = 8, 250                    # T = 256
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0])
    q = np.zeros((B, coded.shape[1], spec.n), np.int8)
    for j in range(spec.n):
        q[..., j] = 1 - 2 * ((coded >> j) & 1).astype(np.int8)
    q = (q * rng.integers(1, 8, q.shape)).astype(np.int8)
    flip = rng.random(q.shape) < 0.04
    q = np.where(flip, -q, q).astype(np.int8)
    q[rng.random(q.shape) < 0.02] = 0          # erasures

    dec = StreamingDecoderBatch(spec, batch=B, soft=True)
    cuts = [96, 149, coded.shape[1]]
    out, prev = [], 0
    for c in cuts:
        out.append(dec.decode(q[:, prev:c], last=(c == cuts[-1])))
        prev = c
    got = np.concatenate(out, axis=1)
    want = np.stack([np.asarray(viterbi_decode_stream_soft(spec, q[b]))
                     for b in range(B)])
    np.testing.assert_array_equal(got, want)


def test_streaming_decoder_soft_single_channel():
    """Single-channel soft StreamingDecoder across ragged seams equals
    the one-shot soft streaming scan."""
    from convolutionalencdec.ops.streaming import StreamingDecoder
    from convolutionalencdec.ops.viterbi import viterbi_decode_stream_soft
    spec = NASA_K7
    rng = np.random.default_rng(41)
    L = 180
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, bits)[0])
    q = np.zeros((coded.shape[0], spec.n), np.int32)
    for j in range(spec.n):
        q[:, j] = (1 - 2 * ((coded >> j) & 1).astype(np.int32)) * 3
    dec = StreamingDecoder(spec, soft=True)
    outs, prev = [], 0
    for c in [53, 121, q.shape[0]]:
        outs.append(dec.decode(q[prev:c], last=(c == q.shape[0])))
        prev = c
    got = np.concatenate(outs)
    want = np.asarray(viterbi_decode_stream_soft(spec, q))
    np.testing.assert_array_equal(got, want)


def test_streaming_batch_kernel_single_plane_w32():
    """A shorter window (W = 32) stays bit-exact vs the scan streaming
    decoder at the same window."""
    from convolutionalencdec.ops.streaming import StreamingDecoderBatch
    from convolutionalencdec.ops.viterbi import viterbi_decode_stream
    spec = NASA_K7
    rng = np.random.default_rng(29)
    B, L = 4, 186
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < 0.02
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    dec = StreamingDecoderBatch(spec, batch=B, traceback_len=32)
    got = dec.decode(coded, last=True)
    want = np.stack([np.asarray(viterbi_decode_stream(spec, coded[b], 32))
                     for b in range(B)])
    np.testing.assert_array_equal(got, want)


def test_stream_traceback_len_must_exceed_s():
    """W <= S would stream decoded termination steps as message bits
    (the flush window is empty) — reject it."""
    segs = np.zeros(64, np.uint8)
    with pytest.raises(ValueError, match="must exceed S"):
        viterbi_decode_stream(NASA_K7, segs,
                              traceback_len=NASA_K7.S)
    # W = S + 1 is the smallest legal window and must work.
    out = viterbi_decode_stream(NASA_K7, segs,
                                traceback_len=NASA_K7.S + 1)
    assert np.asarray(out).shape == (64 - NASA_K7.S,)


def test_block_streaming_matches_one_shot():
    """BlockStreamingDecoderBatch: exact carried-metric chunked decode
    (the core, interpreted) equals the one-shot block decode across
    ragged chunk feeds."""
    import convolutionalencdec as fec
    from convolutionalencdec.kernels import viterbi_decode_batch
    from convolutionalencdec.ops.streaming import (
        BlockStreamingDecoderBatch)
    spec = fec.NASA_K7
    rng = np.random.default_rng(71)
    B, L = 4, 700
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(fec.encode_bits(spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < 0.03
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    want = np.asarray(viterbi_decode_batch(spec, coded, None, True))

    for cuts in ([200, 410, 460], [48], [33, 77, 300, 555, 700],
                 [coded.shape[1]]):
        dec = BlockStreamingDecoderBatch(spec, batch=B, interpret=True)
        got, prev = [], 0
        edges = [c for c in cuts if c < coded.shape[1]] + [coded.shape[1]]
        for i, edge in enumerate(edges):
            got.append(dec.decode(coded[:, prev:edge],
                                  last=(i == len(edges) - 1)))
            prev = edge
        got = np.concatenate(got, axis=1)
        assert got.shape == (B, L), (cuts, got.shape)
        np.testing.assert_array_equal(got, want, err_msg=str(cuts))


def test_block_streaming_rejects_non_swar():
    import convolutionalencdec as fec
    from convolutionalencdec.ops.streaming import (
        BlockStreamingDecoderBatch)
    with pytest.raises(ValueError):
        BlockStreamingDecoderBatch(fec.TOY_K3, batch=4)


def test_block_streaming_soft_matches_one_shot():
    """Soft block streaming (LLR magnitudes 7 and 31) equals the
    one-shot soft block decode across chunk seams."""
    import convolutionalencdec as fec
    from convolutionalencdec.kernels import viterbi_decode_batch_soft
    from convolutionalencdec.ops.streaming import (
        BlockStreamingDecoderBatch)
    rng = np.random.default_rng(73)
    B, L = 4, 400
    for spec, qmax in ((fec.NASA_K7, 7), (fec.NASA_K7, 31)):
        msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
        coded = np.asarray(fec.encode_bits(spec, msgs)[0]).copy()
        flip = rng.random(coded.shape) < 0.03
        coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
        planes = np.stack([(coded >> b) & 1 for b in range(spec.n)],
                          axis=-1)
        q = ((1 - 2 * planes.astype(np.int8)) * qmax).astype(np.int8)
        want = np.asarray(viterbi_decode_batch_soft(spec, q, None, True))
        dec = BlockStreamingDecoderBatch(spec, batch=B, interpret=True,
                                         soft=True)
        g1 = np.asarray(dec.decode(q[:, :144]))
        g2 = np.asarray(dec.decode(q[:, 144:250]))
        g3 = np.asarray(dec.decode(q[:, 250:], last=True))
        got = np.concatenate([g1, g2, g3], axis=1)
        np.testing.assert_array_equal(got, want, err_msg=str(qmax))


def test_block_streaming_rate13_dense_renorm():
    """n=3 codes: the carried-metric seam stays exact there too."""
    import convolutionalencdec as fec
    from convolutionalencdec.kernels import viterbi_decode_batch
    from convolutionalencdec.ops.streaming import (
        BlockStreamingDecoderBatch)
    spec = fec.NASA_K7_R13
    rng = np.random.default_rng(79)
    B, L = 4, 300
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(fec.encode_bits(spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < 0.04
    coded ^= (flip * rng.integers(1, 8, coded.shape)).astype(np.uint8)
    want = np.asarray(viterbi_decode_batch(spec, coded, None, True))
    dec = BlockStreamingDecoderBatch(spec, batch=B, interpret=True)
    got = np.concatenate(
        [np.asarray(dec.decode(coded[:, :120])),
         np.asarray(dec.decode(coded[:, 120:], last=True))], axis=1)
    np.testing.assert_array_equal(got, want)


def test_streaming_auto_fallback_non_poly_symmetric():
    """A valid k=1 NS=64 code WITHOUT poly symmetry streams through the
    batched scan without error."""
    import convolutionalencdec as fec
    from convolutionalencdec.ops.streaming import StreamingDecoderBatch
    from convolutionalencdec.ops.viterbi import viterbi_decode_stream

    spec = fec.CodeSpec(K=7, k=1, g=(0o134, 0o171))
    assert not spec.has_poly_symmetry
    rng = np.random.default_rng(5)
    msgs = rng.integers(0, 2, (4, 256), dtype=np.uint8)
    coded = np.asarray(fec.encode_bits(spec, msgs)[0])
    dec = StreamingDecoderBatch(spec, batch=4)
    out = np.concatenate(
        [np.asarray(dec.decode(coded[:, :128])),
         np.asarray(dec.decode(coded[:, 128:], last=True))], axis=1)
    want = np.stack([np.asarray(viterbi_decode_stream(spec, c))
                     for c in coded])
    np.testing.assert_array_equal(out, want)


def test_block_streaming_rejects_tiny_lookahead():
    """lookahead <= S would emit termination steps as data and break
    the final flush — rejected up front."""
    import convolutionalencdec as fec
    from convolutionalencdec.ops.streaming import (
        BlockStreamingDecoderBatch)
    with pytest.raises(ValueError, match="lookahead"):
        BlockStreamingDecoderBatch(fec.NASA_K7, batch=4, lookahead=0)
    with pytest.raises(ValueError, match="lookahead"):
        BlockStreamingDecoderBatch(fec.NASA_K7, batch=4, lookahead=6)


def test_streaming_decoder_short_packet_exact_length():
    """Packets shorter than the traceback window must decode to EXACTLY
    their message length (the flush trims register-init filler by
    consumed-step count — W-1-S fixed-length emission was a bug)."""
    spec = NASA_K7                     # W = 35, S = 6
    rng = np.random.default_rng(53)
    dec = StreamingDecoder(spec)
    for L in (1, 5, 10, 28, 29, 40):   # spans count < and > W-1
        msg = rng.integers(0, 2, L, dtype=np.uint8)
        coded = np.asarray(encode_bits(spec, msg)[0])
        out = dec.decode(coded, last=True)
        assert out.shape == (L,), (L, out.shape)
        np.testing.assert_array_equal(out, msg)
    # chunked short packet: same answer across a chunk seam
    msg = rng.integers(0, 2, 12, dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msg)[0])
    out = np.concatenate([dec.decode(coded[:7]),
                          dec.decode(coded[7:], last=True)])
    np.testing.assert_array_equal(out, msg)


def test_streaming_batch_short_packet_and_empty_chunk():
    """Batch twin of the short-packet law, plus: an empty NON-last chunk
    must be a no-op (the scalar class accepts it; the batch class
    crashed on np.concatenate([]))."""
    from convolutionalencdec.ops.streaming import StreamingDecoderBatch
    spec = NASA_K7
    rng = np.random.default_rng(59)
    B, L = 3, 10
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0])
    dec = StreamingDecoderBatch(spec, batch=B)
    empty = dec.decode(np.zeros((B, 0), np.uint8))
    assert empty.shape == (B, 0)
    out = dec.decode(coded, last=True)
    assert out.shape == (B, L)
    np.testing.assert_array_equal(out, msgs)


def test_bsc_segments_preserves_uint8():
    import jax
    from convolutionalencdec.ops.channel import bsc_segments
    segs = np.random.default_rng(0).integers(0, 4, (4, 64), np.uint8)
    out = bsc_segments(jax.random.PRNGKey(0), segs, 2, 0.1)
    assert out.dtype == np.uint8, out.dtype
    assert out.shape == segs.shape
