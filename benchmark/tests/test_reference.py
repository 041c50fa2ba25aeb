"""The traffic copies against the program's originals, and the plain
reference against the program's decoders, at tiny sizes on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import convolutionalencdec as fec
from convolutionalencdec import kernels
from convolutionalencdec.ops import channel as prog_channel
from convolutionalencdec.ops import puncture as prog_puncture
from convolutionalencdec.ops.metrics import quantize_llrs
from convolutionalencdec.ops.streaming import BlockStreamingDecoderBatch

from benchmark.harness import channel
from benchmark.reference import viterbi as ref

K7 = (7, (0o133, 0o171))
P34 = ((1, 1, 0), (1, 0, 1))


def noisy(seed, rows, bits, p=0.03):
    k = channel.key(seed)
    msgs = jax.random.bernoulli(k, 0.5, (rows, bits)).astype(jnp.uint8)
    seg = channel.encode(msgs, *K7)
    return msgs, seg, channel.flip_segments(jax.random.fold_in(k, 1), seg, 2, p)


def test_encoder_copy_matches_program():
    msgs, seg, _ = noisy(1, 5, 40)
    want, _ = fec.encode_bits(fec.NASA_K7, msgs)
    np.testing.assert_array_equal(seg, want)
    for spec in (fec.TOY_K3, fec.K5_23_35):
        got = channel.encode(msgs, spec.K, spec.g)
        np.testing.assert_array_equal(got, fec.encode_bits(spec, msgs)[0])


def test_channel_copies_match_program():
    _, seg, _ = noisy(2, 3, 30)
    np.testing.assert_array_equal(channel.segments_to_bits(seg, 2),
                                  prog_channel.segments_to_bits(seg, 2))
    T = seg.shape[1]
    np.testing.assert_array_equal(
        channel.keep_positions(P34, T),
        np.nonzero(prog_puncture.puncture_mask(P34, T))[0])
    llr = jax.random.normal(channel.key(3), (4, 50)) * 5
    np.testing.assert_array_equal(channel.quantize(llr, 7),
                                  quantize_llrs(llr, 7).astype(jnp.int8))


def test_flip_segments_rate_and_range():
    seg = jnp.zeros((64, 1000), jnp.uint8)
    out = np.asarray(channel.flip_segments(channel.key(4), seg, 2, 0.03))
    assert out.max() <= 3
    assert 0.02 < (out != 0).mean() < 0.04


def test_large_seeds_differ():
    big = 2 ** 31 + 12345
    a = channel.make_buffers({"code": {"K": 7, "generators": [91, 121]},
                              "input": "hard",
                              "channel": {"segment_flip_p": 0.03}},
                             2, 16, big, 2)
    b = channel.make_buffers({"code": {"K": 7, "generators": [91, 121]},
                              "input": "hard",
                              "channel": {"segment_flip_p": 0.03}},
                             2, 16, big + 2 ** 32, 2)
    assert not np.array_equal(a[0], b[0]) and not np.array_equal(a[0], a[1])


def test_noiseless_decode_returns_the_message():
    msgs, seg, _ = noisy(5, 4, 60)
    np.testing.assert_array_equal(ref.block_decode(seg, *K7, 60), msgs)


@pytest.mark.parametrize("spec", [fec.NASA_K7, fec.K5_23_35],
                         ids=["k7", "k5"])
def test_block_reference_matches_program_hard(spec):
    k = channel.key(6)
    msgs = jax.random.bernoulli(k, 0.5, (16, 96)).astype(jnp.uint8)
    seg = channel.flip_segments(jax.random.fold_in(k, 1),
                                channel.encode(msgs, spec.K, spec.g), 2, 0.06)
    want = kernels.viterbi_decode_batch(spec, seg)
    got = ref.block_decode(seg, spec.K, spec.g, 96)
    np.testing.assert_array_equal(got, want)


def test_block_reference_matches_program_soft_punctured():
    cfg = {"code": {"K": 7, "generators": [91, 121]}, "input": "soft_punctured",
           "puncture": [list(r) for r in P34],
           "channel": {"ebn0_db": 3.0, "qmax": 7}}
    q = channel.make_input(channel.key(7), cfg, 16, 120)
    T = 126
    want = kernels.viterbi_decode_batch_punctured_soft(fec.NASA_K7, q, P34, T)
    got = ref.block_decode(ref.depuncture(q, P34, T), *K7, 120)
    np.testing.assert_array_equal(got, want)
    assert int(jnp.sum(got != want)) == 0


def test_depuncture_against_program():
    q = jnp.arange(1, 1 + 2 * 84, dtype=jnp.int8).reshape(2, 84)
    want = prog_puncture.depuncture_llrs(q, P34, 63).reshape(2, 63, 2)
    np.testing.assert_array_equal(ref.depuncture(q, P34, 63), want)


@pytest.mark.parametrize("chunk", [48, 16, 100])
def test_stream_reference_matches_program(chunk):
    _, _, x = noisy(8, 4, 300)
    T = x.shape[1]
    dec = BlockStreamingDecoderBatch(fec.NASA_K7, 4, lookahead=35)
    ends = ref.chunk_ends(T, chunk)
    outs = [dec.decode(x[:, a:b], last=b == T)
            for a, b in zip([0] + ends[:-1], ends)]
    got = jnp.concatenate(outs, axis=1)
    want = ref.stream_decode(x, *K7, chunk, 35)
    assert got.shape == want.shape == (4, 300)
    np.testing.assert_array_equal(got, want)


def test_pack_bits():
    bits = jnp.asarray([[1, 0, 0, 0, 0, 0, 0, 1, 1]], jnp.uint8)
    np.testing.assert_array_equal(ref.pack_bits(bits), [[0x81, 0x80]])
