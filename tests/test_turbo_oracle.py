"""Independent C++ turbo oracle (native/turbo_oracle.cpp) vs the JAX
chain — the MATLAB-oracle pattern (SURVEY.md §4 item 4) applied to the
turbo code: an independently written implementation must agree
bit-for-bit on identical inputs, and its measured BER pins the
statistical acceptance constants (`harness.curve.TURBO_EXPECTED`)."""

import numpy as np
import pytest

from convolutionalencdec.ops.turbo import (
    RscSpec, qpp_interleaver, turbo_decode, turbo_encode_np)

native = pytest.importorskip("convolutionalencdec.native")

RSC = RscSpec()


def test_oracle_encode_matches_all_streams():
    rng = np.random.default_rng(5)
    for L in (40, 104, 512):
        pi = qpp_interleaver(L)
        bits = rng.integers(0, 2, L, dtype=np.uint8)
        want = turbo_encode_np(RSC, bits, pi)
        got = native.turbo_oracle_encode(RSC, bits, pi)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_oracle_decode_bit_identical_to_jax():
    rng = np.random.default_rng(6)
    L = 104
    pi = qpp_interleaver(L)
    for trial in range(3):
        bits = rng.integers(0, 2, L, dtype=np.uint8)
        enc = turbo_encode_np(RSC, bits, pi)

        def llr(b):
            x = (1 - 2 * b.astype(np.int32)) * 4
            fl = rng.random(b.shape) < 0.08
            return np.where(fl, -x, x).astype(np.int32)

        args = [llr(enc["sys"]), llr(enc["par1"]), llr(enc["par2"]),
                llr(enc["sys_tail1"]), llr(enc["par_tail1"]),
                llr(enc["sys_tail2"]), llr(enc["par_tail2"])]
        ob = native.turbo_oracle_decode(RSC, *args, pi, n_iters=4)
        jb, _ = turbo_decode(RSC, *args, tuple(int(p) for p in pi), 4)
        np.testing.assert_array_equal(ob, np.asarray(jb))


def test_oracle_decode_clamp_binding_bit_identical():
    """LA_CLAMP is part of the algorithm: at LLR magnitudes large
    enough that the extrinsic exchange actually saturates the clamp,
    the C++ oracle and the JAX scan must still agree bit-for-bit."""
    from convolutionalencdec.ops.turbo import (
        LA_CLAMP, rsc_maxlogmap)
    rng = np.random.default_rng(17)
    L = 104
    pi = qpp_interleaver(L)
    bits = rng.integers(0, 2, L, dtype=np.uint8)
    enc = turbo_encode_np(RSC, bits, pi)

    def llr(b):
        x = (1 - 2 * b.astype(np.int32)) * 50000
        fl = rng.random(b.shape) < 0.08
        return np.where(fl, -x, x).astype(np.int32)

    args = [llr(enc["sys"]), llr(enc["par1"]), llr(enc["par2"]),
            llr(enc["sys_tail1"]), llr(enc["par_tail1"]),
            llr(enc["sys_tail2"]), llr(enc["par_tail2"])]
    # establish that this case BINDS: the first DEC1 pass's scaled
    # extrinsic already exceeds the clamp somewhere
    lapp1 = np.asarray(rsc_maxlogmap(
        RSC, args[0], args[1], np.zeros(L, np.int32), args[3], args[4]))
    le1 = lapp1 - args[0]
    assert (np.abs(3 * le1 // 4) > LA_CLAMP).any()
    ob = native.turbo_oracle_decode(RSC, *args, pi, n_iters=4)
    jb, _ = turbo_decode(RSC, *args, tuple(int(p) for p in pi), 4)
    np.testing.assert_array_equal(ob, np.asarray(jb))


def test_oracle_campaign_sane():
    # small self-contained campaign: decoding gain over the raw channel
    pi = qpp_interleaver(104)
    ber, bler = native.turbo_oracle_ber_point(
        RSC, 104, pi, 2.0, n_blocks=200, n_iters=4, seed=1)
    assert ber < 5e-3           # raw BPSK BER at 2 dB w/ rate 1/3 ~ 0.1
    assert 0.0 <= bler <= 1.0
