"""Ragged-batch decode: per-channel packet lengths in one call.

Ground truth is the per-packet decoder sliced to each channel's own
length — exactly what a user of the reference would do with one
`viterbiDecoderHardButterflyk1(..., last=true)` call per packet
(viterbiDecoderButterflyk1.c:82-260).  The batched ragged paths (scan
reference and the decoder core) must match it bit-for-bit, with zero
padding past each channel's message bits.
"""

import numpy as np
import pytest

from convolutionalencdec import (
    NASA_K7, TOY_K3, encode_bits, viterbi_decode,
    viterbi_decode_ragged, viterbi_decode_ragged_soft, viterbi_decode_soft,
)
from convolutionalencdec.kernels import (
    viterbi_decode_batch_bytes_ragged,
    viterbi_decode_batch_ragged,
    viterbi_decode_batch_soft_bytes_ragged,
)
from convolutionalencdec.ops.bits import pack_bits
from convolutionalencdec.ops.channel import segments_to_bits
from convolutionalencdec.ops.metrics import hard_bits_to_qllrs
from convolutionalencdec.params import CodeSpec

K2_RATE23 = CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13))


def _ragged_batch(spec, rng, msg_lens, flip_p=0.04):
    """Encode per-channel messages, pad to a common Tmax, flip bits."""
    T = [ln // spec.k + spec.S for ln in msg_lens]
    Tmax = max(T)
    B = len(msg_lens)
    segs = np.zeros((B, Tmax), np.uint8)
    msgs = []
    for b, ln in enumerate(msg_lens):
        msg = rng.integers(0, 2, ln, dtype=np.uint8)
        coded = np.asarray(encode_bits(spec, msg)[0]).copy()
        flip = rng.random(coded.shape) < flip_p
        coded ^= (flip * rng.integers(1, 2 ** spec.n, coded.shape)
                  ).astype(np.uint8)
        segs[b, : coded.shape[0]] = coded
        msgs.append(msg)
    # Garbage (not zeros) past each row's end: the decode must ignore it.
    for b in range(B):
        segs[b, T[b]:] = rng.integers(0, 2 ** spec.n, Tmax - T[b])
    return msgs, segs, np.asarray(T, np.int32)


def _per_channel_ref(spec, segs, seg_lens, Lmax):
    """Loop of per-packet decodes, zero-padded to a rectangle."""
    out = np.zeros((segs.shape[0], Lmax), np.uint8)
    for b, t in enumerate(seg_lens):
        bits = np.asarray(viterbi_decode(spec, segs[b, :t]))
        out[b, : bits.shape[0]] = bits
    return out


@pytest.mark.parametrize("spec", [NASA_K7, TOY_K3, K2_RATE23],
                         ids=["K7", "K3", "k2"])
def test_scan_ragged_matches_per_channel(spec):
    rng = np.random.default_rng(7)
    lens = [40 * spec.k, 64 * spec.k, 8 * spec.k, 61 * spec.k]
    msgs, segs, seg_lens = _ragged_batch(spec, rng, lens)
    Lmax = (segs.shape[1] - spec.S) * spec.k
    ref = _per_channel_ref(spec, segs, seg_lens, Lmax)
    got = np.asarray(viterbi_decode_ragged(spec, segs, seg_lens))
    np.testing.assert_array_equal(got, ref)
    for b, msg in enumerate(msgs):
        # Implementation equivalence is the contract; message recovery
        # additionally holds for the strong K=7 code at this noise (the
        # toy codes may decode past their correction limit).
        if spec is NASA_K7:
            np.testing.assert_array_equal(got[b, : len(msg)], msg)
        assert not got[b, len(msg):].any()


def test_kernel_ragged_matches_scan_reference():
    spec = NASA_K7
    rng = np.random.default_rng(11)
    # Lengths probing group boundaries: multiples of 8, off-by-one, the
    # full Tmax, and a minimal packet.
    lens = [256, 255, 249, 8, 1, 129, 250, 256]
    # 2% keeps all ~1400 message bits inside K=7's correction power so
    # the recovery assert is stable; implementation equivalence below is
    # noise-level independent.
    msgs, segs, seg_lens = _ragged_batch(spec, rng, lens, flip_p=0.02)
    ref = np.asarray(viterbi_decode_ragged(spec, segs, seg_lens))
    got = np.asarray(
        viterbi_decode_batch_ragged(spec, segs, seg_lens, interpret=True))
    np.testing.assert_array_equal(got, ref)
    for b, msg in enumerate(msgs):
        np.testing.assert_array_equal(got[b, : len(msg)], msg)


def test_kernel_ragged_uniform_equals_batch():
    """All-equal lengths must reproduce the plain batched decoder."""
    from convolutionalencdec.kernels import viterbi_decode_batch
    spec = NASA_K7
    rng = np.random.default_rng(13)
    msgs, segs, seg_lens = _ragged_batch(spec, rng, [120] * 3)
    got = np.asarray(
        viterbi_decode_batch_ragged(spec, segs, seg_lens, interpret=True))
    ref = np.asarray(viterbi_decode_batch(spec, segs, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_kernel_ragged_bytes():
    spec = NASA_K7
    rng = np.random.default_rng(17)
    lens = [64, 61, 256, 17]
    msgs, segs, seg_lens = _ragged_batch(spec, rng, lens)
    bits = np.asarray(viterbi_decode_ragged(spec, segs, seg_lens))
    Lmax = bits.shape[1]
    pad = (-Lmax) % 8
    ref = np.asarray(pack_bits(np.pad(bits, ((0, 0), (0, pad)))))
    got = np.asarray(viterbi_decode_batch_bytes_ragged(
        spec, segs, seg_lens, interpret=True))
    np.testing.assert_array_equal(got, ref)


def _qllrs_from_segs(spec, segs):
    B, T = segs.shape
    bits = np.asarray(segments_to_bits(segs, spec.n))
    return np.asarray(hard_bits_to_qllrs(bits)).reshape(
        B, T, spec.n).astype(np.int8)


def test_soft_ragged_scan_matches_per_channel():
    spec = NASA_K7
    rng = np.random.default_rng(19)
    lens = [40, 64, 8, 61]
    msgs, segs, seg_lens = _ragged_batch(spec, rng, lens)
    q = _qllrs_from_segs(spec, segs)
    got = np.asarray(viterbi_decode_ragged_soft(spec, q, seg_lens))
    Lmax = got.shape[1]
    ref = np.zeros((len(lens), Lmax), np.uint8)
    for b, t in enumerate(seg_lens):
        bits = np.asarray(viterbi_decode_soft(spec, q[b, :t]))
        ref[b, : bits.shape[0]] = bits
    np.testing.assert_array_equal(got, ref)
    for b, msg in enumerate(msgs):
        np.testing.assert_array_equal(got[b, : len(msg)], msg)


@pytest.mark.parametrize("qmax", [7, 31], ids=["swar8", "swar16"])
def test_soft_ragged_kernel_bytes(qmax):
    """Soft ragged bytes through the core, LLR magnitudes 1 and 9."""
    spec = NASA_K7
    rng = np.random.default_rng(23)
    lens = [64, 61, 129, 17]
    msgs, segs, seg_lens = _ragged_batch(spec, rng, lens)
    scale = 1 if qmax == 7 else 9
    q = (scale * _qllrs_from_segs(spec, segs)).astype(np.int8)
    bits = np.asarray(viterbi_decode_ragged_soft(spec, q, seg_lens))
    pad = (-bits.shape[1]) % 8
    ref = np.asarray(pack_bits(np.pad(bits, ((0, 0), (0, pad)))))
    got = np.asarray(viterbi_decode_batch_soft_bytes_ragged(
        spec, q, seg_lens, interpret=True))
    np.testing.assert_array_equal(got, ref)
