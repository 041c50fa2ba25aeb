"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from convolutionalencdec import NASA_K7, encode_bits, viterbi_decode
from convolutionalencdec.parallel import (
    decode_sharded, encode_sharded, make_mesh,
)


def _noisy(rng, spec, B, L, p):
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < p
    coded ^= (flip * rng.integers(1, 4, coded.shape)).astype(np.uint8)
    return msgs, coded


@pytest.mark.parametrize("mesh_shape", [(8, 1), (2, 4), (1, 8)],
                         ids=["ch8", "ch2tb4", "tb8"])
def test_sharded_decode_bit_exact(mesh_shape):
    """Sharded output must be bit-identical to the single-stream decoder
    (SURVEY.md §7 step 7's validation gate)."""
    spec = NASA_K7
    rng = np.random.default_rng(11)
    B, L = 8, 2042                     # T = 2048, divisible by every ntb
    msgs, coded = _noisy(rng, spec, B, L, 0.02)
    mesh = make_mesh(*mesh_shape)
    out = np.asarray(decode_sharded(spec, coded, mesh))[:, :L]
    ref = np.asarray(jax.vmap(lambda c: viterbi_decode(spec, c))(coded))
    np.testing.assert_array_equal(out, ref)
    # At 2% coded-bit flips a few residual errors beyond the correction
    # limit are expected — but both decoders must make the SAME ones.
    assert (out != msgs).mean() < 1e-3


def test_sharded_encode_matches_unsharded():
    spec = NASA_K7
    rng = np.random.default_rng(13)
    msgs = rng.integers(0, 2, (16, 512), dtype=np.uint8)
    mesh = make_mesh(2, 4)
    got = np.asarray(encode_sharded(spec, msgs, mesh))
    want = np.asarray(encode_bits(spec, msgs)[0])
    np.testing.assert_array_equal(got, want)


def test_sharded_decode_rejects_unshardable():
    spec = NASA_K7
    mesh = make_mesh(2, 4)
    coded = np.zeros((8, 1023), np.uint8)   # 1023 % 4 != 0
    with pytest.raises(ValueError):
        decode_sharded(spec, coded, mesh)


def test_channel_sharded_kernel_decode():
    """Block decode (the core, interpreted) sharded over all 8 devices
    (channel axis) is bit-identical to the unsharded decode."""
    from convolutionalencdec.parallel import decode_sharded_batch
    from convolutionalencdec.kernels import viterbi_decode_batch
    spec = NASA_K7
    rng = np.random.default_rng(31)
    msgs, coded = _noisy(rng, spec, 8, 122, 0.03)
    mesh = make_mesh(8, 1)
    got = np.asarray(decode_sharded_batch(spec, coded, mesh,
                                          interpret=True))
    want = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)],
                         ids=["ch2tb4", "tb8"])
def test_time_sharded_kernel_decode(mesh_shape):
    """Time-block decode on the core's forward and traceback
    (overlap-save) is bit-identical to the unsharded block decoder —
    the multi-device long-stream path."""
    from convolutionalencdec.parallel import decode_sharded_kernel
    from convolutionalencdec.kernels import viterbi_decode_batch
    spec = NASA_K7
    rng = np.random.default_rng(47)
    B, L = 4, 1146                     # T = 1152; Tl = 288/144 >= W
    msgs, coded = _noisy(rng, spec, B, L, 0.02)
    mesh = make_mesh(*mesh_shape)
    got = np.asarray(decode_sharded_kernel(spec, coded, mesh,
                                           interpret=True))[:, :L]
    want = np.asarray(viterbi_decode_batch(spec, coded, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (got != msgs).mean() < 1e-3


def test_time_sharded_kernel_rejects_misaligned():
    from convolutionalencdec.parallel import decode_sharded_kernel
    spec = NASA_K7
    mesh = make_mesh(1, 8)
    coded = np.zeros((4, 1024), np.uint8)   # 1024/8 = 128 < warmup 144
    with pytest.raises(ValueError):
        decode_sharded_kernel(spec, coded, mesh)


def test_turbo_chain_sharded():
    """LTE turbo receive chain channel-sharded over the mesh, bit-exact
    vs the unsharded batch decode."""
    from convolutionalencdec.ops import lte
    from convolutionalencdec.parallel import turbo_decode_sharded
    rng = np.random.default_rng(19)
    B, L, E = 16, 40, 132
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    tx = np.asarray(lte.lte_turbo_encode_batch(msgs, E))
    q = ((1 - 2 * tx.astype(np.int32)) * 6).astype(np.int32)
    flip = rng.random(q.shape) < 0.04
    q = np.where(flip, -q, q)
    mesh = make_mesh(4, 2)
    got = turbo_decode_sharded(q, L, mesh, n_iters=2)
    ref, _ = lte.lte_turbo_decode(q, L, n_iters=2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_tbcc_crc_receiver_sharded():
    """CRC-aided TBCC list receiver channel-sharded over the mesh,
    identical verdicts and bits vs the unsharded receiver."""
    from convolutionalencdec import LTE_TBCC_K7, encode_tailbiting
    from convolutionalencdec.ops.tailbiting import (
        viterbi_decode_tailbiting_crc_soft)
    from convolutionalencdec.ops.crc import CRC16_CCITT, crc_append
    from convolutionalencdec.parallel import tbcc_crc_decode_sharded
    spec, crc = LTE_TBCC_K7, CRC16_CCITT
    rng = np.random.default_rng(29)
    B, L = 16, 48
    payload = rng.integers(0, 2, (B, L - 16), dtype=np.uint8)
    msgs = np.asarray(crc_append(crc, payload))
    coded = np.asarray(encode_tailbiting(spec, msgs))
    planes = np.stack([(coded >> j) & 1 for j in range(spec.n)], axis=-1)
    q = ((1 - 2 * planes.astype(np.int8)) * 4).astype(np.int8)
    flip = rng.random(q.shape) < 0.03
    q = np.where(flip, -q, q).astype(np.int8)
    mesh = make_mesh(8, 1)
    got, ok = tbcc_crc_decode_sharded(spec, crc, q, 4, mesh)
    ref, rok, _ = viterbi_decode_tailbiting_crc_soft(spec, crc, q, 4)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(rok))


def test_sharded_decode_rejects_short_local_blocks():
    """Local time blocks shorter than the warm-up must raise instead of
    silently decoding garbage (halos reach only one neighbor)."""
    import pytest
    from convolutionalencdec.parallel import decode_sharded, make_mesh
    spec = NASA_K7
    mesh = make_mesh(1, 8)
    segs = np.zeros((8, 512), np.uint8)       # Tl = 64 < W = 128
    with pytest.raises(ValueError, match="warmup"):
        decode_sharded(spec, segs, mesh)
