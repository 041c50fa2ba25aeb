"""Throughput harnesses — speedEncode/speedDecode equivalents.

Methodology mirrors the reference benches (speedEncode.c:37-103,
speedDecode.c:41-116): pre-generate a warm working set, run the operation
in a steady-state loop, report Mbit/s of uncoded-side bits.  Here the
working set is NBUF device-resident batches of channels taken in turn,
the device dispatch queue plays the role of the pinned worker thread, and
`block_until_ready` replaces the compiler barriers around the timers.

Run as a module for the endless-loop behavior of the originals:
    python -m convolutionalencdec.harness.speed [encode|decode|ragged]
"""

from __future__ import annotations

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec, NASA_K7
from ..ops.encode import encode_bits
from ..utils.telemetry import ThroughputMeter, describe

#: Distinct pre-staged buffers per bench (the reference round-robins 16
#: packets, speedDecode.c:55-60).
NBUF = 8


def _steady_loop(call, bufs, bits_per_call: int, seconds: float,
                 verbose: bool, label: str) -> float:
    """Steady state: NBUF calls (one per distinct buffer) per blocking
    tick, until `seconds` have passed."""
    meter = ThroughputMeter()
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        for buf in bufs:
            out = call(buf)
        jax.block_until_ready(out)
        line = meter.tick(bits_per_call * len(bufs))
        if verbose and line:
            print(f"{label}: {line}", flush=True)
    return meter.average_mbps


def _noisy_bufs(spec: CodeSpec, coded: np.ndarray, rng, flip_p: float):
    """NBUF device-resident independent corruptions of `coded`."""
    out = []
    for _ in range(NBUF):
        flip = rng.random(coded.shape) < flip_p
        noisy = coded ^ (flip * rng.integers(1, 1 << spec.n, coded.shape)
                         ).astype(np.uint8)
        out.append(jax.device_put(jnp.asarray(noisy)))
    return out


def bench_encode(spec: CodeSpec = NASA_K7, *, batch: int = 1024,
                 packet_bits: int = 8192, seconds: float = 3.0,
                 verbose: bool = False) -> float:
    """Steady-state encoder throughput in Mbit/s (uncoded bits consumed,
    the reference's metric, speedEncode.c:91-92)."""
    rng = np.random.default_rng(16)   # 16 packets round-robin in the ref
    bufs = [jax.device_put(jnp.asarray(
        rng.integers(0, 2, (batch, packet_bits), dtype=np.uint8)))
        for _ in range(NBUF)]
    enc = jax.jit(lambda b: encode_bits(spec, b, True)[0])
    enc(bufs[0]).block_until_ready()     # compile
    return _steady_loop(enc, bufs, batch * packet_bits, seconds, verbose,
                        "encode")


def bench_decode(spec: CodeSpec = NASA_K7, *, batch: int = 1024,
                 packet_bits: int = 2048, seconds: float = 5.0,
                 flip_p: float = 0.03, verbose: bool = False) -> float:
    """Steady-state decoder throughput in Mbit/s (decoded bits,
    speedDecode.c:103-104)."""
    from ..kernels import viterbi_decode_batch
    rng = np.random.default_rng(16)
    msgs = rng.integers(0, 2, (batch, packet_bits), dtype=np.uint8)
    coded = np.asarray(encode_bits(spec, msgs)[0])
    bufs = _noisy_bufs(spec, coded, rng, flip_p)
    decode = functools.partial(viterbi_decode_batch, spec)
    decode(bufs[0]).block_until_ready()  # compile
    return _steady_loop(decode, bufs, batch * packet_bits, seconds,
                        verbose, "decode")


def bench_decode_ragged(spec: CodeSpec = NASA_K7, *, batch: int = 1024,
                        lengths=(2048,), seconds: float = 5.0,
                        flip_p: float = 0.03,
                        verbose: bool = False) -> float:
    """Steady-state RAGGED-batch decode throughput in Mbit/s of decoded
    message bits (sum of per-channel lengths per call).

    Channel b gets message length `lengths[b % len(lengths)]`.  With a
    single entry this isolates the ragged machinery's overhead against
    `bench_decode` (same work, per-channel masks live); with mixed
    lengths it measures real mixed-traffic service rate, where the
    shorter channels' padding to Tmax is the dominant cost — the number
    an operator comparing against one-packet-per-call serving
    (the reference's only mode) actually cares about.
    """
    from ..kernels import viterbi_decode_batch_bytes_ragged
    rng = np.random.default_rng(16)
    lens = np.asarray([lengths[i % len(lengths)] for i in range(batch)])
    T = lens + spec.S
    Tmax = int(T.max())
    segs = np.zeros((batch, Tmax), np.uint8)
    for L in sorted(set(int(x) for x in lens)):
        idx = np.nonzero(lens == L)[0]
        msgs = rng.integers(0, 2, (len(idx), L), dtype=np.uint8)
        segs[idx, : L + spec.S] = np.asarray(encode_bits(spec, msgs)[0])
    bufs = _noisy_bufs(spec, segs, rng, flip_p)
    lens_dev = jax.device_put(jnp.asarray(T, jnp.int32))
    decode = functools.partial(viterbi_decode_batch_bytes_ragged, spec,
                               seg_lengths=lens_dev)
    decode(bufs[0]).block_until_ready()   # compile
    return _steady_loop(decode, bufs, int(lens.sum()), seconds, verbose,
                        "ragged decode")


def main(argv):
    which = argv[1] if len(argv) > 1 else "decode"
    print(describe(NASA_K7))
    if which == "encode":
        print(f"encoder: {bench_encode(verbose=True):.2f} Mbit/s avg")
    elif which == "ragged":
        print(f"ragged (uniform 2048): "
              f"{bench_decode_ragged(verbose=True):.2f} Mbit/s avg")
        print(f"ragged (mixed 2048/1024/512/1536): "
              f"{bench_decode_ragged(lengths=(2048, 1024, 512, 1536), verbose=True):.2f}"
              f" Mbit/s avg")
    else:
        print(f"decoder: {bench_decode(verbose=True):.2f} Mbit/s avg")


if __name__ == "__main__":
    main(sys.argv)
