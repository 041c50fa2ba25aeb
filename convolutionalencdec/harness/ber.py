"""BER validation harness — the berTestK7 equivalent (berTestK7/berTestK7.c).

The reference's acceptance test: push tens of megabits through
encode -> IID bit-flip channel -> decode at three SNR operating points and
require the measured coded BER to sit within 10% relative error of the
MATLAB-vitdec-derived expectations (berTestK7.c:15,95-100,167-172).

Batched re-design: packets are batched as channels and decoded together
(the whole point of this build); the channel corruption is a pure function of
a jax PRNG key (fault injection as a product feature, SURVEY.md §5), so a
full operating point is a handful of device launches instead of 10,000
serial packet loops.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec, NASA_K7
from ..ops.channel import bsc_segments, uncoded_ber_bpsk
from ..ops.encode import encode_bits
from ..ops.viterbi import viterbi_decode

#: The reference's three operating points (berTestK7.c:95-103): BPSK at
#: SNR in {-5,-4,-3} dB with 4x oversampling, i.e. uncoded BERs p, and the
#: expected coded BERs produced by MATLAB vitdec full-traceback simulation
#: (viterbiBEREstimate.m:99).  NOTE these expectations belong to the
#: (133,171) code the MATLAB scripts simulate (viterbiBEREstimate.m:11).
BER_EXPECTED_K7 = (
    # (snr_db, uncoded_ber, expected_coded_ber)
    (-5.0, 5.5856e-2, 4.765898e-3),
    (-4.0, 3.7162e-2, 5.184082e-4),
    (-3.0, 2.2622e-2, 3.499023e-5),
)

#: Pass threshold: 10% relative error (berTestK7.c:15).
ALLOWED_RELATIVE_ERROR = 0.10


@dataclasses.dataclass
class BerPointResult:
    snr_db: float
    uncoded_ber: float
    expected_coded_ber: float | None
    measured_coded_ber: float
    measured_uncoded_ber: float
    bits_tested: int
    errors: int

    @property
    def relative_error(self) -> float | None:
        if self.expected_coded_ber is None:
            return None
        return abs(self.measured_coded_ber - self.expected_coded_ber) / \
            self.expected_coded_ber

    @property
    def passed(self) -> bool | None:
        rel = self.relative_error
        return None if rel is None else rel <= ALLOWED_RELATIVE_ERROR


def _default_decoder(spec: CodeSpec):
    """Batched decoder (`kernels.viterbi_decode_batch`: the decoder core
    on the GPU, the vmapped scan elsewhere)."""
    from ..kernels import viterbi_decode_batch
    return functools.partial(viterbi_decode_batch, spec)


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def _gen_and_corrupt(spec: CodeSpec, key, n_packets: int, packet_bits: int,
                     p):
    kmsg, kchan = jax.random.split(key)
    msgs = jax.random.bernoulli(
        kmsg, 0.5, (n_packets, packet_bits)).astype(jnp.uint8)
    coded, _ = encode_bits(spec, msgs)
    noisy = bsc_segments(kchan, coded, spec.n, p)
    return msgs, coded, noisy


def ber_point(spec: CodeSpec, uncoded_ber: float, *, n_packets: int = 10000,
              packet_bits: int = 2048, seed: int = 9865,
              batch: int = 1024, decoder: Callable | None = None,
              snr_db: float = float("nan"),
              expected: float | None = None) -> BerPointResult:
    """Measure coded BER at one operating point.

    Mirrors one iteration of berTestK7's config loop (berTestK7.c:109-174):
    random packets, encode, IID coded-bit flips at `uncoded_ber`, decode,
    count errors.  Packets are processed in device-sized batches.
    """
    decoder = decoder or _default_decoder(spec)
    key = jax.random.PRNGKey(seed)
    total_err = 0
    total_chan_err = 0
    total_bits = 0
    total_coded_bits = 0
    done = 0
    while done < n_packets:
        nb = min(batch, n_packets - done)
        key, sub = jax.random.split(key)
        msgs, coded, noisy = _gen_and_corrupt(
            spec, sub, nb, packet_bits, uncoded_ber)
        decoded = decoder(noisy)
        msgs, decoded = np.asarray(msgs), np.asarray(decoded)
        total_err += int((decoded != msgs).sum())
        total_bits += msgs.size
        # Channel sanity accounting (berTestK7.c:151-152).
        x = np.asarray(coded) ^ np.asarray(noisy)
        total_chan_err += int(sum(((x >> j) & 1).sum()
                                  for j in range(spec.n)))
        total_coded_bits += x.size * spec.n
        done += nb
    return BerPointResult(
        snr_db=snr_db,
        uncoded_ber=uncoded_ber,
        expected_coded_ber=expected,
        measured_coded_ber=total_err / total_bits,
        measured_uncoded_ber=total_chan_err / total_coded_bits,
        bits_tested=total_bits,
        errors=total_err,
    )


def run_reference_ber_test(spec: CodeSpec = NASA_K7, *,
                           n_packets: int = 10000, packet_bits: int = 2048,
                           seed: int = 9865, decoder: Callable | None = None,
                           verbose: bool = True) -> list[BerPointResult]:
    """The full berTestK7 acceptance run: 3 SNR points x n_packets packets.

    Returns the per-point results; every point must satisfy
    `result.passed` (<= 10% relative error vs the MATLAB expectation).
    """
    results = []
    for snr_db, p, expected in BER_EXPECTED_K7:
        r = ber_point(spec, p, n_packets=n_packets, packet_bits=packet_bits,
                      seed=seed, decoder=decoder, snr_db=snr_db,
                      expected=expected)
        if verbose:
            print(f"SNR {snr_db:+.0f} dB: coded BER {r.measured_coded_ber:.6e}"
                  f" vs expected {expected:.6e}"
                  f" ({100 * r.relative_error:.2f}% err)"
                  f" [{'PASS' if r.passed else 'FAIL'}]")
        results.append(r)
    return results


def ber_sweep(spec: CodeSpec, snrs_db: Sequence[float], *,
              oversample: int = 4, n_packets: int = 1000,
              packet_bits: int = 2048, seed: int = 0,
              decoder: Callable | None = None) -> list[BerPointResult]:
    """BER curve over arbitrary SNR points (BASELINE.json config 3's
    0-10 dB Eb/N0 runner), using the BPSK-matched uncoded BER mapping the
    reference uses (berTestK7.c:103)."""
    return [
        ber_point(spec, uncoded_ber_bpsk(s, oversample), n_packets=n_packets,
                  packet_bits=packet_bits, seed=seed, decoder=decoder,
                  snr_db=s)
        for s in snrs_db
    ]
