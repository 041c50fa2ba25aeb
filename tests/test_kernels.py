"""Batched decode entry tests (`kernels.*`, the decoder core in the
Pallas interpreter where `interpret=True` and the code is a butterfly
code; the scan decoders otherwise).

The contract: `kernels.viterbi_decode_batch` is bit-identical to the scan
reference decoder `viterbi_decode` on every input — the generic-vs-
specialized cross-check SURVEY.md §4 carries over from the reference's
handTracedTest caveats.
"""

import numpy as np
import pytest

import jax

from convolutionalencdec import (
    NASA_K7, REF_K7, TOY_K3, encode_bits, viterbi_decode,
)
from convolutionalencdec.kernels import viterbi_decode_batch


def _noisy_batch(spec, rng, B, L, flip_p):
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < flip_p
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    return msgs, coded


@pytest.mark.parametrize("spec", [NASA_K7, REF_K7], ids=lambda s: f"g{s.g}")
def test_kernel_matches_scan_decoder(spec):
    rng = np.random.default_rng(3)
    msgs, coded = _noisy_batch(spec, rng, 3, 122, 0.03)
    ref = np.asarray(jax.vmap(lambda c: viterbi_decode(spec, c))(coded))
    got = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, msgs)


def test_kernel_heavy_noise_still_matches():
    """Beyond the correction limit decisions must still be identical
    (implementation equivalence, not correction)."""
    spec = NASA_K7
    rng = np.random.default_rng(5)
    _, coded = _noisy_batch(spec, rng, 2, 122, 0.25)
    ref = np.asarray(jax.vmap(lambda c: viterbi_decode(spec, c))(coded))
    got = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_kernel_multi_chunk_and_padding():
    """T spanning multiple CHUNK-sized grid steps plus ragged padding."""
    spec = NASA_K7
    rng = np.random.default_rng(7)
    msgs, coded = _noisy_batch(spec, rng, 2, 250, 0.02)  # T=256 -> 2 chunks
    got = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    np.testing.assert_array_equal(got, msgs)


def test_soft_kernel_matches_soft_scan():
    """Soft Pallas kernel vs the scan soft decoder, random LLRs."""
    from convolutionalencdec.kernels import viterbi_decode_batch_soft
    from convolutionalencdec.ops.metrics import viterbi_decode_soft
    spec = NASA_K7
    rng = np.random.default_rng(9)
    B, L = 2, 122
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0])
    # ±1 LLRs from the coded bits with sign flips + erasures sprinkled in.
    q = np.zeros((B, coded.shape[1], spec.n), np.int32)
    for j in range(spec.n):
        q[..., j] = 1 - 2 * ((coded >> j) & 1).astype(np.int32)
    q *= rng.integers(1, 8, q.shape)               # random magnitudes
    flip = rng.random(q.shape) < 0.04
    q = np.where(flip, -q, q)
    q[rng.random(q.shape) < 0.02] = 0              # erasures
    ref = np.stack([np.asarray(viterbi_decode_soft(spec, q[i]))
                    for i in range(B)])
    got = np.asarray(viterbi_decode_batch_soft(spec, q, interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, msgs)


def test_soft8_kernel_extreme_llrs_match_scan():
    """Adversarial LLRs pinned to ±7 (max per-step metric growth at the
    default quantizer) decode bit-identically to the int32 soft scan."""
    from convolutionalencdec.kernels import viterbi_decode_batch_soft
    from convolutionalencdec.ops.metrics import viterbi_decode_soft
    spec = NASA_K7
    rng = np.random.default_rng(17)
    B, T = 2, 150
    q = rng.choice(np.array([-7, 7], np.int32), size=(B, T, spec.n))
    ref = np.stack([np.asarray(viterbi_decode_soft(spec, q[i]))
                    for i in range(B)])
    got = np.asarray(viterbi_decode_batch_soft(spec, q, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_soft16_path_matches_scan():
    """Wider LLRs (|q| <= 31) match the scan too (any-int8 exactness)."""
    from convolutionalencdec.kernels import viterbi_decode_batch_soft
    from convolutionalencdec.ops.metrics import viterbi_decode_soft
    spec = NASA_K7
    rng = np.random.default_rng(19)
    B, T = 2, 122
    q = rng.integers(-31, 32, size=(B, T, spec.n)).astype(np.int32)
    ref = np.stack([np.asarray(viterbi_decode_soft(spec, q[i]))
                    for i in range(B)])
    got = np.asarray(viterbi_decode_batch_soft(spec, q, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_soft_kernel_hard_llrs_match_hard_kernel():
    spec = NASA_K7
    from convolutionalencdec.kernels import viterbi_decode_batch_soft
    rng = np.random.default_rng(13)
    msgs, coded = _noisy_batch(spec, rng, 2, 122, 0.05)
    q = np.zeros((2, coded.shape[1], spec.n), np.int32)
    for j in range(spec.n):
        q[..., j] = 1 - 2 * ((coded >> j) & 1).astype(np.int32)
    hard = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    soft = np.asarray(viterbi_decode_batch_soft(spec, q, interpret=True))
    np.testing.assert_array_equal(hard, soft)


@pytest.mark.parametrize("spec_name", ["K5_23_35", "K9_561_753"])
def test_kernel_other_constraint_lengths(spec_name):
    """The core is generic over num_states (16 and 256 states here),
    not just the K=7 flagship."""
    import convolutionalencdec as fec
    spec = getattr(fec, spec_name)
    rng = np.random.default_rng(19)
    L = 128 - spec.S
    msgs, coded = _noisy_batch(spec, rng, 2, L, 0.02)
    ref = np.asarray(jax.vmap(lambda c: viterbi_decode(spec, c))(coded))
    got = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_generic_kernel_k2_matches_scan():
    """viterbi_decode_batch on a k=2 rate-2/3 code (no butterfly
    symmetry) dispatches to the generic 2^k-way scan and matches the
    per-packet decoder bit-for-bit (viterbiDecoder.c:95-131)."""
    from convolutionalencdec.params import CodeSpec
    from convolutionalencdec.ops.encode import encode_bits
    spec = CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13))
    rng = np.random.default_rng(71)
    B, L = 8, 120                       # 60 symbols, T = 62
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < 0.05
    coded ^= (flip * rng.integers(1, 8, coded.shape)).astype(np.uint8)
    got = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    want = np.stack([np.asarray(viterbi_decode(spec, coded[b]))
                     for b in range(B)])
    np.testing.assert_array_equal(got, want)
    assert (got != msgs).mean() < 0.1


def test_generic_kernel_asymmetric_k1():
    """A k=1 code WITHOUT poly symmetry rides the generic scan."""
    from convolutionalencdec.params import CodeSpec
    from convolutionalencdec.ops.encode import encode_bits
    spec = TOY_K3                        # g=(7,6): no poly symmetry
    rng = np.random.default_rng(72)
    B, L = 4, 100
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < 0.04
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    got = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    want = np.stack([np.asarray(viterbi_decode(spec, coded[b]))
                     for b in range(B)])
    np.testing.assert_array_equal(got, want)


def test_k2_fused_kernel_matches_scan():
    """A k=2 64-state code matches the per-packet scan decoder
    bit-for-bit through the batch entry, including on tie-heavy garbage
    input (argmin's lowest-e tie order)."""
    from convolutionalencdec.params import CodeSpec
    from convolutionalencdec.ops.encode import encode_bits
    spec = CodeSpec(K=4, k=2, g=(0o64, 0o52, 0o71))
    rng = np.random.default_rng(73)
    B, L = 4, 2 * 70
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    clean = np.asarray(encode_bits(spec, msgs)[0]).copy()
    noisy = clean.copy()
    flip = rng.random(noisy.shape) < 0.05
    noisy ^= (flip * rng.integers(1, 8, noisy.shape)).astype(np.uint8)
    garbage = rng.integers(0, 8, clean.shape, dtype=np.uint8)
    for coded in (noisy, garbage):
        got = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
        want = np.stack([np.asarray(viterbi_decode(spec, coded[b]))
                         for b in range(B)])
        np.testing.assert_array_equal(got, want)


def test_rate13_soft_rides_swar16():
    """Rate-1/3 K=7 soft decode (n=3 LLR planes) matches the scan."""
    from convolutionalencdec.kernels import viterbi_decode_batch_soft
    from convolutionalencdec.ops.metrics import viterbi_decode_soft
    from convolutionalencdec.params import NASA_K7_R13
    spec = NASA_K7_R13
    rng = np.random.default_rng(53)
    B, L = 2, 75
    q = rng.integers(-9, 10, (B, L + spec.S, spec.n)).astype(np.int8)
    got = np.asarray(viterbi_decode_batch_soft(spec, q, interpret=True))
    ref = np.asarray(jax.vmap(
        lambda qq: viterbi_decode_soft(spec, qq.astype(np.int32)))(q))
    np.testing.assert_array_equal(got, ref)


def test_rate13_hard_rides_swar_dense_renorm():
    """n=3 hard decode (3-bit Hamming metrics) stays bit-exact."""
    from convolutionalencdec.params import NASA_K7_R13
    spec = NASA_K7_R13
    rng = np.random.default_rng(59)
    msgs, coded = _noisy_batch(spec, rng, 3, 150, 0.05)
    ref = np.asarray(jax.vmap(lambda c: viterbi_decode(spec, c))(coded))
    got = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, msgs)


def test_ns256_tile_dispatch_soft_and_ragged():
    """NS = 256 (four decision words per parity) across the soft and
    ragged surfaces, bit-exact vs the scan references
    (viterbiDecoder.c:52-234 semantics)."""
    import convolutionalencdec as fec
    from convolutionalencdec.kernels import (
        viterbi_decode_batch_ragged, viterbi_decode_batch_soft)
    from convolutionalencdec.ops.metrics import viterbi_decode_soft
    from convolutionalencdec.ops.viterbi import viterbi_decode_ragged

    spec = fec.K9_561_753
    rng = np.random.default_rng(41)

    # soft path at NS=256
    msgs, coded = _noisy_batch(spec, rng, 2, 120, 0.04)
    q = np.zeros((2, coded.shape[1], spec.n), np.int32)
    for j in range(spec.n):
        q[..., j] = 5 * (1 - 2 * ((coded >> j) & 1).astype(np.int32))
    got = np.asarray(viterbi_decode_batch_soft(spec, q, interpret=True))
    want = np.stack([np.asarray(viterbi_decode_soft(spec, q[b]))
                     for b in range(2)])
    np.testing.assert_array_equal(got, want)

    # ragged path at NS=256 (mixed lengths in one kernel call)
    lens = [64, 120]
    Tmax = max(ln + spec.S for ln in lens)
    segs = np.zeros((2, Tmax), np.uint8)
    for b, ln in enumerate(lens):
        msg = rng.integers(0, 2, ln, dtype=np.uint8)
        cw = np.asarray(encode_bits(spec, msg)[0])
        segs[b, :cw.shape[0]] = cw
    seg_lens = np.asarray([ln + spec.S for ln in lens], np.int32)
    got = np.asarray(
        viterbi_decode_batch_ragged(spec, segs, seg_lens, interpret=True))
    want = np.asarray(viterbi_decode_ragged(spec, segs, seg_lens))
    np.testing.assert_array_equal(got, want)
