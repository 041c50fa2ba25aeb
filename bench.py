"""Headline throughput bench — speedDecode's equivalent on one NVIDIA GPU.

Methodology mirrors the reference's speed harness (speedDecode.c:41-116):
pre-encode a warm working set, run the decoder in steady state, report
Mbit/s of decoded (uncoded-side) bits.  Here the working set is NBUF
distinct batches of B=2048 channels x L=2048-bit packets (K=7 (133,171),
3% segment corruption) resident on the card, and the decoder is the
block decode to packed bytes (`kernels.viterbi_decode_batch_bytes`: the
Hopper core on the GPU).  Each timed window calls the decoder on the
NBUF buffers in turn and ends in `block_until_ready`.  The baseline is
the reference's measured ~23.5 Mbit/s single-core decode (BASELINE.md).

The bench refuses to run without a GPU.  Prints ONE JSON line:
  {"metric": "decode_throughput", "value": N, "unit": "Mbit/s",
   "vs_baseline": N / 23.5, "device_kind": ..., "power_limit": ...}
`--turbo` runs the turbo serving bench instead; `--profile` also writes
a `jax.profiler` trace under `traces/` at the checkout's root.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import convolutionalencdec as fec  # noqa: E402
from convolutionalencdec.utils.device import (  # noqa: E402
    CHECKOUT, gpu_identity, require_gpu, setup_compile_cache)

BASELINE_MBPS = 23.5  # reference speedDecode on 1 vCPU (BASELINE.md)

# The reference has no turbo codec; the single-core baseline for the
# --turbo row is the repo's own independent C++ direct-form decoder
# (native/turbo_oracle.cpp): 1.03 ms/block = 1.0 Mbit/s for 6-iteration
# max-log decode at L=1024 on one CPU core (g++ -O2).
TURBO_BASELINE_MBPS = 1.0

NBUF = 8
WINDOWS = 5


def _steady_seconds_per_call(call, bufs) -> float:
    """Best of WINDOWS windows; each calls once per buffer and ends in
    `block_until_ready`.  Returns seconds per call."""
    best = float("inf")
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for b in bufs:
            out = call(b)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / len(bufs))
    return best


def _profile(call, bufs, name: str):
    trace_dir = os.path.join(CHECKOUT, "traces", name)
    jax.profiler.start_trace(trace_dir)
    for b in bufs:
        out = call(b)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    print(f"profiler trace written to {trace_dir}", file=sys.stderr)


def _report(metric: str, mbps: float, baseline: float, dev, ident: str):
    print(json.dumps({
        "metric": metric,
        "value": mbps,
        "unit": "Mbit/s",
        "vs_baseline": mbps / baseline,
        "device_kind": dev.device_kind,
        "power_limit": ident.split(",")[-1].strip(),
    }))


def turbo_main(dev, ident: str):
    """Turbo serving bench: B=2048 blocks x L=1024 (CRC24B payloads),
    rate 1/2 at 2.0 dB, `lte_turbo_decode_early` (CRC-gated while_loop)
    with serving outputs only (packed message bytes + ok + iters).
    Reports decoded message Mbit/s of wall time."""
    from convolutionalencdec.ops import lte
    from convolutionalencdec.ops.bits import pack_bits
    from convolutionalencdec.ops.channel import awgn, bpsk_llr, bpsk_modulate
    from convolutionalencdec.ops.crc import CRC24B, crc_append
    from convolutionalencdec.ops.metrics import quantize_llrs

    B, L = 2048, 1024
    E = 2 * (L + 4)
    EBN0 = 2.0
    rate = L / E
    kmsg, kch = jax.random.split(jax.random.PRNGKey(9865))
    payload = jax.random.bernoulli(kmsg, 0.5, (B, L - 24)).astype(jnp.uint8)
    msgs = np.asarray(crc_append(CRC24B, payload))
    tx = lte.lte_turbo_encode_batch(jnp.asarray(msgs), E)

    def make_q(k):
        rx = awgn(k, bpsk_modulate(tx), EBN0, rate)
        return quantize_llrs(bpsk_llr(rx, EBN0, rate),
                             qmax=31).astype(jnp.int32)

    bufs = [jax.device_put(make_q(k)) for k in jax.random.split(kch, NBUF)]

    @jax.jit
    def serve(q):
        bits, _, ok, iters = lte.lte_turbo_decode_early(q, L)
        return pack_bits(bits), ok, iters

    by, ok, iters = serve(bufs[0])
    got = np.unpackbits(np.asarray(by), axis=1)[:, :L]
    ok_np = np.asarray(ok)
    wrong = (got != msgs).any(1)
    if (ok_np & wrong).any():
        raise SystemExit("false accept in the turbo bench")
    if ok_np.mean() <= 0.99:
        raise SystemExit(f"accept rate {ok_np.mean()} at {EBN0} dB")

    dt = _steady_seconds_per_call(serve, bufs)
    if "--profile" in sys.argv:
        _profile(serve, bufs, "trace_turbo")
    print(f"early-term at {EBN0} dB: iters={int(iters)} "
          f"accept={ok_np.mean():.4f} wall {dt * 1e3:.3f} ms/call; {ident}",
          file=sys.stderr)
    _report("turbo_decode_throughput", B * L / dt / 1e6,
            TURBO_BASELINE_MBPS, dev, ident)


def main(dev, ident: str):
    from convolutionalencdec.kernels import viterbi_decode_batch_bytes
    spec = fec.NASA_K7
    # Working set: B channels x L-bit packets (the reference uses 16 x
    # 2048-bit packets, speedDecode.c:55-60).
    B, L = 2048, 2048
    rng = np.random.default_rng(9865)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(fec.encode_bits(spec, msgs)[0])
    bufs = []
    for _ in range(NBUF):
        flip = rng.random(coded.shape) < 0.03
        noisy = coded ^ (flip * rng.integers(1, 4, coded.shape)).astype(
            np.uint8)
        bufs.append(jax.device_put(jnp.asarray(noisy)))

    def decode(c):
        return viterbi_decode_batch_bytes(spec, c)

    # Compile, then check: at 3% segment corruption a small residual BER
    # survives (correctly); a broken decoder is off by orders of magnitude.
    got = np.unpackbits(np.asarray(decode(bufs[0])), axis=1)[:, :L]
    ber = float((got != msgs).mean())
    if ber >= 2e-3:
        raise SystemExit(f"decode BER {ber} implausibly high in bench")

    dt = _steady_seconds_per_call(decode, bufs)
    if "--profile" in sys.argv:
        from convolutionalencdec.utils import traffic_report
        _profile(decode, bufs, "trace_decode")
        print(traffic_report(spec, B, L + spec.S), file=sys.stderr)
    print(f"decode B={B} L={L}: {dt * 1e3:.3f} ms/call; {ident}",
          file=sys.stderr)
    _report("decode_throughput", B * L / dt / 1e6, BASELINE_MBPS, dev,
            ident)


if __name__ == "__main__":
    setup_compile_cache()
    device = require_gpu()
    identity = gpu_identity()
    if "--turbo" in sys.argv:
        turbo_main(device, identity)
    else:
        main(device, identity)
