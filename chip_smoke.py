"""Smoke run of the main decode path on one NVIDIA GPU (or four with
`--multi`), in one process.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # four cards: the sharded decoders only

One card, at the bench's shape (NASA K=7, B=2048 channels x L=2048 bits):

1. compiles the Hopper core's hard and soft block decode and prints
   `compiled.memory_analysis()`;
2. checks the core bit-exact against the on-device `lax.scan` decoder on
   all 2048 channels, hard (3% segment corruption) and soft (quantized
   AWGN LLRs), and against the C++ oracle on 16 channels; residual BER
   below 2e-3;
3. times the core against the scan, end to end to packed bytes;
4. runs `lte_turbo_decode_early` at the turbo bench's shape (B=2048,
   L=1024, rate 1/2, 2 dB): zero false accepts, blocks against the C++
   turbo oracle, and its time;
5. runs the `gpu`-marked tests in this process (`pytest -m gpu`).

`--multi` runs `parallel.decode_sharded_batch` over a ch=4 mesh and
`parallel.decode_sharded_kernel` over a (1, 4) time-block mesh on one
long stream, each bit-exact against the unsharded core.

Any failure raises; without a GPU the script exits non-zero before any
result.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import convolutionalencdec as fec  # noqa: E402
from convolutionalencdec.utils.device import (  # noqa: E402
    gpu_identity, require_gpu, setup_compile_cache)

SPEC = fec.NASA_K7
B, L = 2048, 2048
REPS = 10
#: --multi's long streams, time-sharded four ways.
STREAMS, STREAM_STEPS = 16, 4 * 65536


def _say(*parts):
    print(*parts, flush=True)


def _time(fn, bufs):
    """Median seconds per call over REPS passes of the buffers."""
    jax.block_until_ready(fn(bufs[0]))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for b in bufs:
            out = fn(b)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / len(bufs))
    return float(np.median(ts))


def _scan_bytes(soft: bool):
    from convolutionalencdec.ops.bits import pack_bits
    from convolutionalencdec.ops.metrics import viterbi_decode_soft

    def one(x):
        if soft:
            return viterbi_decode_soft(SPEC, x.astype(jnp.int32))
        return fec.viterbi_decode(SPEC, x)

    return jax.jit(lambda xb: pack_bits(jax.vmap(one)(xb)))


def _hard_inputs(rng, n):
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(fec.encode_bits(SPEC, msgs)[0])
    out = []
    for _ in range(n):
        flip = rng.random(coded.shape) < 0.03
        out.append(coded ^ (flip * rng.integers(1, 4, coded.shape)).astype(
            np.uint8))
    return msgs, out


def _soft_inputs(key, n, ebn0=3.0):
    from convolutionalencdec.ops.channel import (
        awgn, bpsk_llr, bpsk_modulate, segments_to_bits)
    from convolutionalencdec.ops.metrics import quantize_llrs
    kmsg, kch = jax.random.split(key)
    msgs = jax.random.bernoulli(kmsg, 0.5, (B, L)).astype(jnp.uint8)
    cbits = segments_to_bits(fec.encode_bits(SPEC, msgs)[0], SPEC.n)
    out = []
    for k in jax.random.split(kch, n):
        llr = bpsk_llr(awgn(k, bpsk_modulate(cbits), ebn0, SPEC.rate),
                       ebn0, SPEC.rate)
        out.append(quantize_llrs(llr).reshape(B, -1, SPEC.n).astype(
            jnp.int8))
    return np.asarray(msgs), out


def block_decode_phase(ident: str):
    from convolutionalencdec.kernels import (
        core, viterbi_decode_batch_bytes, viterbi_decode_batch_soft_bytes)
    from convolutionalencdec.native import oracle_decode
    assert core.use_kernel(SPEC)
    rng = np.random.default_rng(2026)
    hard_msgs, hard = _hard_inputs(rng, 4)
    soft_msgs, soft = _soft_inputs(jax.random.PRNGKey(2026), 4)
    for name, fn, msgs, xs, is_soft in (
            ("hard", viterbi_decode_batch_bytes, hard_msgs, hard, False),
            ("soft", viterbi_decode_batch_soft_bytes, soft_msgs, soft, True)):
        xs = [jax.device_put(jnp.asarray(x)) for x in xs]
        core_fn = jax.jit(lambda x, fn=fn: fn(SPEC, x))
        compiled = core_fn.lower(xs[0]).compile()
        _say(f"[{name}] core compiled at B={B} L={L}: "
             f"{compiled.memory_analysis()}")
        scan_fn = _scan_bytes(is_soft)
        got = np.asarray(compiled(xs[0]))
        want = np.asarray(scan_fn(xs[0]))
        np.testing.assert_array_equal(got, want)
        _say(f"[{name}] core == on-device scan, bit-exact on all {B} "
             f"channels ({got.shape[1]} bytes each)")
        bits = np.unpackbits(got, axis=1)[:, :L]
        ber = float((bits != msgs).mean())
        if ber >= 2e-3:
            raise AssertionError(f"[{name}] residual BER {ber} >= 2e-3")
        # C++ oracle (hard decisions): the hard input as is; for soft, the
        # signs of the LLRs as hard segments (+-1 pseudo-LLRs decode
        # exactly like Hamming metrics).
        if is_soft:
            neg = np.asarray(xs[0][:16]) < 0
            seg = sum(neg[..., j].astype(np.uint8) << j
                      for j in range(SPEC.n))
            pseudo = np.where(neg, -1, 1).astype(np.int8)
            mine = np.unpackbits(np.asarray(fn(SPEC, pseudo)), axis=1)[:, :L]
        else:
            seg = np.asarray(xs[0][:16])
            mine = bits[:16]
        cpp = np.stack([oracle_decode(SPEC, s) for s in seg])
        np.testing.assert_array_equal(mine, cpp)
        _say(f"[{name}] core == C++ oracle on 16 channels; residual BER "
             f"{ber:.3e} (< 2e-3)")
        t_core = _time(compiled, xs)
        t_scan = _time(scan_fn, xs)
        _say(f"[{name}] timing B={B} L={L} to bytes: core "
             f"{t_core * 1e3:.3f} ms/call ({B * L / t_core / 1e6:.1f} "
             f"Mbit/s), XLA scan {t_scan * 1e3:.3f} ms/call "
             f"({B * L / t_scan / 1e6:.1f} Mbit/s), core {t_scan / t_core:.1f}x"
             f" faster; card: {ident}")


def turbo_phase(ident: str):
    from convolutionalencdec.native import turbo_oracle_decode
    from convolutionalencdec.ops import lte
    from convolutionalencdec.ops.channel import awgn, bpsk_llr, bpsk_modulate
    from convolutionalencdec.ops.crc import CRC24B, crc_append
    from convolutionalencdec.ops.metrics import quantize_llrs
    from convolutionalencdec.ops.turbo import RscSpec
    Bt, Lt = 2048, 1024
    E = 2 * (Lt + 4)
    ebn0, rate = 2.0, Lt / E
    kmsg, kch = jax.random.split(jax.random.PRNGKey(9865))
    payload = jax.random.bernoulli(kmsg, 0.5, (Bt, Lt - 24)).astype(
        jnp.uint8)
    msgs = np.asarray(crc_append(CRC24B, payload))
    tx = lte.lte_turbo_encode_batch(jnp.asarray(msgs), E)
    rx = awgn(kch, bpsk_modulate(tx), ebn0, rate)
    q = quantize_llrs(bpsk_llr(rx, ebn0, rate), qmax=31).astype(jnp.int32)
    early = jax.jit(lambda x: lte.lte_turbo_decode_early(x, Lt))
    bits, _, ok, iters = early(q)
    bits, ok = np.asarray(bits), np.asarray(ok)
    wrong = (bits != msgs).any(1)
    false_accepts = int((ok & wrong).sum())
    if false_accepts:
        raise AssertionError(f"turbo: {false_accepts} false accepts")
    if ok.mean() <= 0.99:
        raise AssertionError(f"turbo: accept rate {ok.mean()} at {ebn0} dB")
    # A few blocks against the independent C++ chain at the same count of
    # iterations (the scan MAP chain, one program, fixed iterations).
    n_it = int(iters)
    fields = lte.turbo_demux_tails(lte.derate_match_turbo(
        q[:4], Lt + 4, qmax=31, filler_llr=31))
    fields = [np.asarray(f) for f in fields]
    fixed, _ = lte.lte_turbo_decode(q[:4], Lt, n_iters=n_it)
    perm = lte.lte_qpp(Lt)
    for b in range(4):
        cpp = turbo_oracle_decode(RscSpec(), *(f[b] for f in fields), perm,
                                  n_it)
        np.testing.assert_array_equal(np.asarray(fixed)[b], cpp)
    t = _time(early, [q])
    _say(f"[turbo] lte_turbo_decode_early B={Bt} L={Lt} rate 1/2 at "
         f"{ebn0} dB: iterations {n_it}, accepted {ok.mean():.4f}, "
         f"0 false accepts, 4 blocks == C++ turbo oracle at {n_it} "
         f"iterations; {t * 1e3:.3f} ms/call ({Bt * Lt / t / 1e6:.1f} "
         f"Mbit/s); card: {ident}")


def gpu_tests_phase():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    if rc != 0:
        raise SystemExit(f"gpu-marked tests failed (pytest exit {rc})")
    _say("[tests] gpu-marked tests passed")


def multi_phase():
    from convolutionalencdec.kernels import viterbi_decode_batch
    from convolutionalencdec.parallel import (
        decode_sharded_batch, decode_sharded_kernel, make_mesh)
    if len(jax.devices()) != 4:
        raise SystemExit(f"--multi needs 4 GPUs; have {jax.devices()}")
    rng = np.random.default_rng(4)
    msgs, (coded,) = _hard_inputs(rng, 1)
    x = jnp.asarray(coded)
    want = np.asarray(viterbi_decode_batch(SPEC, x))
    got = np.asarray(decode_sharded_batch(SPEC, x, make_mesh(4, 1)))
    np.testing.assert_array_equal(got, want)
    _say(f"[multi] decode_sharded_batch over ch=4: B={B} L={L} bit-exact "
         f"vs the unsharded core on all channels")
    Bs, Ls = STREAMS, STREAM_STEPS - SPEC.S
    m = rng.integers(0, 2, (Bs, Ls), dtype=np.uint8)
    c = np.asarray(fec.encode_bits(SPEC, m)[0])
    flip = rng.random(c.shape) < 0.03
    c = jnp.asarray(c ^ (flip * rng.integers(1, 4, c.shape)).astype(np.uint8))
    want = np.asarray(viterbi_decode_batch(SPEC, c))
    got = np.asarray(decode_sharded_kernel(SPEC, c, make_mesh(1, 4)))[:, :Ls]
    np.testing.assert_array_equal(got, want)
    _say(f"[multi] decode_sharded_kernel over a (1, 4) time-block mesh: "
         f"{Bs} streams x {c.shape[1]} steps bit-exact vs the unsharded "
         f"core")


def main():
    setup_compile_cache()
    dev = require_gpu()
    ident = gpu_identity()
    _say(f"devices: {jax.devices()}")
    if "--multi" in sys.argv:
        multi_phase()
    else:
        block_decode_phase(ident)
        turbo_phase(ident)
        gpu_tests_phase()
    _say(ident)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
