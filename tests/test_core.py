"""The Hopper decoder core (kernels/core.py) in the Pallas interpreter.

Each case runs the Triton-route kernels with `interpret=True` on small
shapes whose batch and length are not multiples of the channel tile, and
compares them with the plain scan decoders and the C++ oracle.  The
`gpu`-marked cases at the end run the compiled kernels on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import convolutionalencdec as fec
from convolutionalencdec.kernels import (
    core, viterbi_decode_batch, viterbi_decode_batch_bytes,
    viterbi_decode_batch_soft, viterbi_decode_batch_soft_bytes)
from convolutionalencdec.native import oracle_decode
from convolutionalencdec.ops.bits import pack_bits
from convolutionalencdec.ops.metrics import (
    viterbi_decode_soft, viterbi_forward_butterfly_soft)
from convolutionalencdec.ops.viterbi import viterbi_forward_butterfly

SPECS = [fec.NASA_K7, fec.REF_K7, fec.LTE_TBCC_K7, fec.K9_561_753]
SPEC_IDS = ["nasa_k7", "ref_k7", "lte_tbcc_k7", "k9"]


def _noisy(spec, rng, B, L, p=0.04):
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(fec.encode_bits(spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < p
    coded ^= (flip * rng.integers(1, 1 << spec.n, coded.shape)).astype(
        np.uint8)
    return msgs, coded


def _soft(spec, coded, rng):
    """Signed LLRs of random magnitude from hard segments, with erasures."""
    planes = np.stack([(coded >> j) & 1 for j in range(spec.n)], axis=-1)
    q = (1 - 2 * planes.astype(np.int32)) * rng.integers(1, 100, planes.shape)
    q[rng.random(q.shape) < 0.03] = 0
    return q.astype(np.int8)


def _pack(bits):
    return np.asarray(pack_bits(np.pad(bits, ((0, 0), (0, (-bits.shape[1]) % 8)))))


@pytest.mark.parametrize("out", ["bits", "bytes"])
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_core_block_decode_matches_scan(spec, soft, out):
    rng = np.random.default_rng(100 + spec.K + 7 * soft)
    B, L = 19, 45                        # B, T off the tile
    msgs, coded = _noisy(spec, rng, B, L)
    if soft:
        x = _soft(spec, coded, rng)
        want = np.asarray(jax.vmap(lambda q: viterbi_decode_soft(
            spec, q.astype(jnp.int32)))(x))
        fn = (viterbi_decode_batch_soft if out == "bits"
              else viterbi_decode_batch_soft_bytes)
    else:
        x = coded
        want = np.asarray(jax.vmap(
            lambda c: fec.viterbi_decode(spec, c))(x))
        fn = (viterbi_decode_batch if out == "bits"
              else viterbi_decode_batch_bytes)
    got = np.asarray(fn(spec, x, None, True))
    np.testing.assert_array_equal(got, want if out == "bits" else _pack(want))
    if not soft:
        cpp = np.stack([oracle_decode(spec, c) for c in coded])
        np.testing.assert_array_equal(want, cpp)
    assert (want != msgs).mean() < 0.05


def test_core_int8_llr_extremes_match_scan():
    """LLRs pinned at +127 / -127 / -128: int32 metrics take them exactly."""
    spec = fec.NASA_K7
    rng = np.random.default_rng(5)
    q = rng.choice(np.array([-128, -127, 127], np.int8), size=(18, 70, spec.n))
    want = np.asarray(jax.vmap(lambda x: viterbi_decode_soft(
        spec, x.astype(jnp.int32)))(q))
    got = np.asarray(viterbi_decode_batch_soft(spec, q, None, True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_core_forward_from_initial_metrics(soft):
    """Forward ACS from arbitrary per-channel metrics: decisions (in the
    core's butterfly word order) and final metrics equal the scan's."""
    spec = fec.NASA_K7
    rng = np.random.default_rng(7)
    B, T = 17, 37
    init = rng.integers(0, 200, (B, spec.num_states)).astype(np.int32)
    _, coded = _noisy(spec, rng, B, T - spec.S, 0.2)
    if soft:
        x = _soft(spec, coded, rng)
        ref = jax.vmap(lambda q, m: viterbi_forward_butterfly_soft(
            spec, q.astype(jnp.int32), m))(x, init)
    else:
        x = coded
        ref = jax.vmap(lambda s, m: viterbi_forward_butterfly(
            spec, s, m))(x, init)
    dec_ref, fm_ref = (np.asarray(a) for a in ref)
    dec, fm = core.acs_forward(spec, x, init, interpret=True)
    dec, fm = np.asarray(dec), np.asarray(fm)
    np.testing.assert_array_equal(fm, fm_ref)
    # word 2w + p, bit j  <->  destination state 2(32w + j) + p
    words = dec[:, :B].view(np.uint32)                   # [T, B, NW]
    s = np.arange(spec.num_states)
    b, p = s >> 1, s & 1
    bits = (words[:, :, (b // 32) * 2 + p] >> (b % 32)) & 1
    np.testing.assert_array_equal(bits.transpose(1, 0, 2), dec_ref)


def _walk_reference(spec, words, start, end, emit):
    """Direct per-channel backward walk over butterfly-order words."""
    T = words.shape[0]
    B = start.shape[0]
    out = np.zeros((B, T), np.uint8)
    for c in range(B):
        s = int(start[c])
        for t in range(int(end[c]) - 1, -1, -1):
            b = s >> 1
            bit = (int(words[t, c, (b // 32) * 2 + (s & 1)]) >> (b % 32)) & 1
            if t < emit[c]:
                out[c, t] = s & 1
            s = b | (bit << (spec.S - 1))
    return out


@pytest.mark.parametrize("spec", [fec.NASA_K7, fec.K9_561_753],
                         ids=["nasa_k7", "k9"])
def test_core_traceback_start_states_and_emit_mask(spec):
    """Traceback from given start states and end steps, with a
    per-channel emit bound, over random decision words."""
    rng = np.random.default_rng(11)
    B, T = 21, 43
    nw = core.num_words(spec)
    Bp = -(-B // core.TILE) * core.TILE
    words = rng.integers(0, 1 << 32, (T, Bp, nw), dtype=np.uint64)
    words = words.astype(np.uint32)
    start = rng.integers(0, spec.num_states, B).astype(np.int32)
    end = rng.integers(0, T + 1, B).astype(np.int32)
    emit = rng.integers(0, T + 1, B).astype(np.int32)
    want = _pack(_walk_reference(spec, words, start, end, emit))
    dec = jnp.asarray(words.view(np.int32))
    got = np.asarray(core.traceback(spec, dec, start, end, emit,
                                    interpret=True))
    np.testing.assert_array_equal(got, want)
    scan = np.asarray(core.traceback(spec, dec, start, end, emit))
    np.testing.assert_array_equal(scan, want)


def test_core_ragged_and_punctured_entries():
    """Per-channel lengths and depunctured erasures through the core."""
    from convolutionalencdec.kernels import (
        viterbi_decode_batch_bytes_ragged, viterbi_decode_batch_punctured)
    from convolutionalencdec.ops.channel import segments_to_bits
    from convolutionalencdec.ops.puncture import PUNCTURE_3_4, puncture_bits
    spec = fec.NASA_K7
    rng = np.random.default_rng(13)
    lens = np.array([5, 40, 17, 33, 40], np.int32)
    T = int(lens.max()) + spec.S
    segs = rng.integers(0, 4, (lens.size, T), dtype=np.uint8)
    for i, ln in enumerate(lens):
        segs[i, :ln + spec.S] = np.asarray(fec.encode_bits(
            spec, rng.integers(0, 2, ln, dtype=np.uint8))[0])
    got = np.asarray(viterbi_decode_batch_bytes_ragged(
        spec, segs, lens + spec.S, True))
    want = _pack(np.asarray(fec.viterbi_decode_ragged(
        spec, segs, lens + spec.S)))
    np.testing.assert_array_equal(got, want)

    msgs, coded = _noisy(spec, rng, 5, 60, 0.0)
    tx = np.asarray(puncture_bits(segments_to_bits(coded, spec.n),
                                  PUNCTURE_3_4, coded.shape[1]))
    got = np.asarray(viterbi_decode_batch_punctured(
        spec, tx, PUNCTURE_3_4, coded.shape[1], None, True))
    np.testing.assert_array_equal(got, msgs)


def test_core_dispatch_is_the_scan_off_the_card():
    """The kernels run exactly when JAX's platform is the GPU, and only
    for butterfly codes."""
    on_gpu = jax.default_backend() == "gpu"
    assert core.use_kernel(fec.NASA_K7) == on_gpu
    assert core.use_kernel(fec.K9_561_753) == on_gpu
    assert not core.use_kernel(fec.TOY_K3)
    assert not core.use_kernel(fec.CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13)))


# ---------------------------------------------------------------------------
# On the card: compiled kernels (no interpreter) against the on-device scan.


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")


@pytest.mark.gpu
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_core_on_gpu_matches_scan(gpu, spec, soft):
    assert core.use_kernel(spec)
    rng = np.random.default_rng(17)
    B, L = 300, 500
    msgs, coded = _noisy(spec, rng, B, L, 0.03)
    if soft:
        x = _soft(spec, coded, rng)
        got = viterbi_decode_batch_soft(spec, x)
        want = jax.vmap(lambda q: viterbi_decode_soft(
            spec, q.astype(jnp.int32)))(x)
    else:
        got = viterbi_decode_batch(spec, coded)
        want = jax.vmap(lambda c: fec.viterbi_decode(spec, c))(coded)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
