"""BER statistical integration test — berTestK7 at reduced scale.

The full reference run is 3 x 10,000 x 2048-bit packets with a 10%
relative-error gate (berTestK7.c:9-15).  CI runs a reduced packet count at
the two low-SNR points (where the statistics converge fastest) with a
looser gate; the full-scale run is `harness.run_reference_ber_test()`.
"""

import numpy as np
import pytest

from convolutionalencdec import NASA_K7
from convolutionalencdec.harness import BER_EXPECTED_K7, ber_point


@pytest.mark.parametrize("snr_db,p,expected", BER_EXPECTED_K7[:2],
                         ids=["snr-5", "snr-4"])
def test_ber_matches_matlab_expectation(snr_db, p, expected):
    r = ber_point(NASA_K7, p, n_packets=4000, packet_bits=2048, seed=9865,
                  batch=500, snr_db=snr_db, expected=expected)
    # Channel sanity: measured uncoded BER close to requested
    # (berTestK7.c:151-152 keeps the same running check).
    assert r.measured_uncoded_ber == pytest.approx(p, rel=0.05)
    # The reference's own 10% relative-error gate (berTestK7.c:168-172)
    # at 8 Mbit/point.  The fixed seed makes the measurement
    # deterministic; 8 Mbit keeps the sampling spread ~3% at -4 dB so the
    # gate holds with margin even if a JAX upgrade redraws the PRNG
    # stream.  The -3 dB point needs ~60 Mbit for converged statistics
    # and stays in the full-scale `run_reference_ber_test()`.
    assert r.measured_coded_ber == pytest.approx(expected, rel=0.10), r
