"""Randomized-CodeSpec fuzz: implementation equivalence across the three
independent decoders (scan reference, C++ oracle, the decoder core in
the Pallas interpreter) on GENERATED codes, not just the curated presets.

The reference can only be rebuilt per code (compile-time macros,
viterbiDecoder.h:8-16); here CodeSpec is runtime, so the dispatch
surface — butterfly core vs generic scan — must hold for arbitrary
valid (K, k, g).  Message recovery is NOT asserted
(a random code may be catastrophic or non-invertible); equivalence is
the contract, as in the reference's generic-vs-butterfly cross-check
(SURVEY.md §4).
"""

import numpy as np
import pytest

import jax

from convolutionalencdec import CodeSpec, encode_bits, viterbi_decode
from convolutionalencdec.kernels import viterbi_decode_batch
from convolutionalencdec.native import oracle_decode, oracle_encode


def _random_specs(seed: int, count: int):
    rng = np.random.default_rng(seed)
    specs = []
    while len(specs) < count:
        k = int(rng.integers(1, 4))            # 1..3
        K = int(rng.integers(2, {1: 8, 2: 4, 3: 3}[k] + 1))
        n = int(rng.integers(max(2, k), 5))    # rate <= 1, n <= 4
        width = k * K
        g = tuple(int(rng.integers(1, 1 << width)) for _ in range(n))
        try:
            spec = CodeSpec(K=K, k=k, g=g)
        except ValueError:
            continue
        specs.append(spec)
    return specs


SPECS = _random_specs(20260818, 10)
IDS = [f"{i}:K{s.K}k{s.k}n{s.n}g{'_'.join(oct(x)[2:] for x in s.g)}"
       for i, s in enumerate(SPECS)]


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_fuzz_spec_three_way_equivalence(spec):
    rng = np.random.default_rng(spec.K * 1000 + spec.k * 100 + spec.n)
    B = 2
    L = 48 * spec.k
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0]).copy()
    # encoder: JAX == C++ oracle
    for b in range(B):
        np.testing.assert_array_equal(coded[b],
                                      oracle_encode(spec, msgs[b]))
    flip = rng.random(coded.shape) < 0.05
    coded ^= (flip * rng.integers(1, 1 << spec.n, coded.shape)).astype(
        np.uint8)
    # decoder: scan == C++ oracle == decoder core, bit for bit
    scan = np.asarray(jax.vmap(lambda c: viterbi_decode(spec, c))(coded))
    for b in range(B):
        np.testing.assert_array_equal(scan[b], oracle_decode(spec, coded[b]))
    kern = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    np.testing.assert_array_equal(kern, scan)


@pytest.mark.parametrize("spec", SPECS, ids=IDS)
def test_fuzz_spec_bytes_and_ragged(spec):
    """The byte and ragged surfaces must stay consistent with the bit
    decoders on generated codes too (packed MSb-first byte semantics,
    per-channel-length masking)."""
    from convolutionalencdec.kernels import (
        viterbi_decode_batch_bytes, viterbi_decode_batch_ragged)
    from convolutionalencdec.ops.bits import pack_bits
    from convolutionalencdec import viterbi_decode_ragged
    rng = np.random.default_rng(spec.K * 77 + spec.k * 7 + spec.n)
    lens = [32 * spec.k, 16 * spec.k, 29 * spec.k]
    T = [ln // spec.k + spec.S for ln in lens]
    Tmax = max(T)
    segs = rng.integers(0, 2 ** spec.n, (len(lens), Tmax), np.uint8)
    for b, ln in enumerate(lens):
        msg = rng.integers(0, 2, ln, dtype=np.uint8)
        coded = np.asarray(encode_bits(spec, msg)[0]).copy()
        flip = rng.random(coded.shape) < 0.05
        coded ^= (flip * rng.integers(1, 2 ** spec.n, coded.shape)
                  ).astype(np.uint8)
        segs[b, : T[b]] = coded
    seg_lens = np.asarray(T, np.int32)
    # ragged batch entry == per-channel scan
    ref = np.zeros((len(lens), (Tmax - spec.S) * spec.k), np.uint8)
    for b in range(len(lens)):
        bits = np.asarray(viterbi_decode(spec, segs[b, : T[b]]))
        ref[b, : bits.shape[0]] = bits
    got = np.asarray(viterbi_decode_batch_ragged(spec, segs, seg_lens,
                                                 interpret=True))
    np.testing.assert_array_equal(got, ref)
    scan_r = np.asarray(viterbi_decode_ragged(spec, segs, seg_lens))
    np.testing.assert_array_equal(scan_r, ref)
    # bytes == pack_bits(bits) on a rectangular batch
    rect = np.stack([segs[0, : T[0]]] * 2)
    bits = np.asarray(viterbi_decode_batch(spec, rect, interpret=True))
    pad = (-bits.shape[-1]) % 8
    exp = np.asarray(pack_bits(np.pad(bits, ((0, 0), (0, pad)))))
    by = np.asarray(viterbi_decode_batch_bytes(spec, rect,
                                               interpret=True))
    np.testing.assert_array_equal(by, exp)


@pytest.mark.parametrize("spec", SPECS[:5], ids=IDS[:5])
def test_fuzz_spec_tailbiting_list(spec):
    # List-decode invariants on arbitrary codes (scan path): candidate 0
    # is exactly the argmin decode of the same left-extended trellis,
    # metrics ascend, shapes match.  (The kernel list path is NS>=64
    # poly-symmetric k=1 only and is cross-checked in tests/test_crc.py.)
    from convolutionalencdec import (encode_tailbiting,
                                         viterbi_decode_tailbiting,
                                         viterbi_decode_tailbiting_list)
    from convolutionalencdec.ops.tailbiting import default_wrap
    rng = np.random.default_rng(spec.K * 77 + spec.k * 7 + spec.n)
    L = 24 * spec.k * 2
    msgs = rng.integers(0, 2, (L,), dtype=np.uint8)
    coded = np.asarray(encode_tailbiting(spec, msgs)).copy()
    flip = rng.random(coded.shape) < 0.05
    coded ^= (flip * rng.integers(1, 1 << spec.n, coded.shape)).astype(
        np.uint8)
    Lc = min(4, spec.num_states)
    cands, mets = viterbi_decode_tailbiting_list(spec, coded, Lc)
    cands, mets = np.asarray(cands), np.asarray(mets)
    assert cands.shape == (Lc, L) and mets.shape == (Lc,)
    assert (np.diff(mets) >= 0).all()
    wl = default_wrap(spec)
    plain = np.asarray(viterbi_decode_tailbiting(spec, coded, (wl, 0)))
    np.testing.assert_array_equal(cands[0], plain)
