"""Eb/N0 BER-curve runner — hard and soft decision over real AWGN/BPSK.

The reference's berCurveCoded.m plots analytic hard/soft expectations
(berCurveCoded.m:46-51); this runner *measures* both paths end-to-end
(encode -> BPSK -> AWGN -> LLR -> [quantize|slice] -> decode) on device,
demonstrating the ~2 dB soft-decision gain.  Emits one JSON line per
point so results can be collected by scripts.

    python -m convolutionalencdec.harness.curve
"""

from __future__ import annotations

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..params import CodeSpec, NASA_K7
from ..ops.channel import (
    awgn, bpsk_llr, bpsk_modulate, bits_to_segments, hard_decision,
    segments_to_bits,
)
from ..ops.encode import encode_bits
from ..kernels import viterbi_decode_batch, viterbi_decode_batch_soft
from ..ops.metrics import quantize_llrs


@functools.partial(jax.jit, static_argnums=(0, 2, 3))
def _curve_batch(spec: CodeSpec, key, n_packets: int, packet_bits: int,
                 ebn0_db):
    """One batch: returns (hard_errors, soft_errors, total_bits)."""
    kmsg, kchan = jax.random.split(key)
    msgs = jax.random.bernoulli(
        kmsg, 0.5, (n_packets, packet_bits)).astype(jnp.uint8)
    coded, _ = encode_bits(spec, msgs)
    cbits = segments_to_bits(coded, spec.n)
    rx = awgn(kchan, bpsk_modulate(cbits), ebn0_db, spec.rate)
    llr = bpsk_llr(rx, ebn0_db, spec.rate)
    hard_segs = bits_to_segments(hard_decision(llr), spec.n)
    q = quantize_llrs(llr).reshape(n_packets, -1, spec.n)
    hard_bits = viterbi_decode_batch(spec, hard_segs)
    soft_bits = viterbi_decode_batch_soft(spec, q)
    hard_err = jnp.sum(hard_bits != msgs)
    soft_err = jnp.sum(soft_bits != msgs)
    return hard_err, soft_err, msgs.size


def run_curve(spec: CodeSpec = NASA_K7, ebn0_points=None, *,
              n_packets: int = 2000, packet_bits: int = 2048,
              batch: int = 500, seed: int = 1, verbose: bool = True):
    """Measure hard + soft coded BER across Eb/N0 points through the
    batched decoders (`kernels.viterbi_decode_batch[_soft]`).

    Returns a list of dicts (one per point).
    """
    if ebn0_points is None:
        ebn0_points = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    results = []
    for ebn0 in ebn0_points:
        key = jax.random.PRNGKey(seed)
        h_err = s_err = total = 0
        done = 0
        while done < n_packets:
            nb = min(batch, n_packets - done)
            key, sub = jax.random.split(key)
            he, se, tot = _curve_batch(spec, sub, nb, packet_bits, ebn0)
            h_err += int(he)
            s_err += int(se)
            total += int(tot)
            done += nb
        point = {
            "ebn0_db": ebn0,
            "hard_ber": h_err / total,
            "soft_ber": s_err / total,
            "bits": total,
        }
        results.append(point)
        if verbose:
            print(json.dumps(point), flush=True)
    return results


@functools.partial(jax.jit, static_argnums=(0, 1, 3, 4, 5))
def _tbcc_bler_batch(spec: CodeSpec, crc, key, n_packets: int,
                     payload_bits: int, list_size: int, ebn0_db):
    """One TBCC batch: (plain_blkerr, list_blkerr, false_accepts, n)."""
    from ..ops.crc import crc_append
    from ..ops.tailbiting import (encode_tailbiting,
                                  viterbi_decode_tailbiting_crc_soft,
                                  viterbi_decode_tailbiting_soft)
    kmsg, kchan = jax.random.split(key)
    payload = jax.random.bernoulli(
        kmsg, 0.5, (n_packets, payload_bits)).astype(jnp.uint8)
    msgs = crc_append(crc, payload)
    coded = encode_tailbiting(spec, msgs)
    cbits = segments_to_bits(coded, spec.n)
    rx = awgn(kchan, bpsk_modulate(cbits), ebn0_db, spec.rate)
    llr = bpsk_llr(rx, ebn0_db, spec.rate)
    q = quantize_llrs(llr).reshape(n_packets, -1, spec.n).astype(jnp.int8)
    plain = jax.vmap(lambda x: viterbi_decode_tailbiting_soft(spec, x))(q)
    out, ok, _ = viterbi_decode_tailbiting_crc_soft(spec, crc, q, list_size)
    plain_blk = jnp.any(plain != msgs, axis=1)
    list_blk = jnp.any(out != msgs, axis=1)
    false_acc = ok & list_blk      # CRC passed but the block is wrong
    return (jnp.sum(plain_blk), jnp.sum(list_blk), jnp.sum(false_acc),
            n_packets)


def run_bler_curve_tbcc(spec: CodeSpec = None, crc=None, ebn0_points=None,
                        *, n_packets: int = 4096, payload_bits: int = 104,
                        list_size: int = 8, batch: int = 1024,
                        seed: int = 7, verbose: bool = True):
    """Measured BLOCK-error curve for the CRC-aided tail-biting list
    decoder vs the plain soft wrap decode (the quality evidence behind
    ops.tailbiting.viterbi_decode_tailbiting_crc_soft) — short LTE-
    control-channel-style blocks over AWGN/BPSK.  Also reports the CRC
    false-accept rate (passing candidates that are wrong blocks).

    Returns a list of dicts, one per Eb/N0 point.
    """
    from ..params import LTE_TBCC_K7
    from ..ops.crc import CRC16_CCITT
    spec = spec or LTE_TBCC_K7
    crc = crc or CRC16_CCITT
    if ebn0_points is None:
        ebn0_points = [0.0, 1.0, 2.0, 3.0]
    results = []
    for ebn0 in ebn0_points:
        key = jax.random.PRNGKey(seed)
        pb = lb = fa = total = 0
        done = 0
        while done < n_packets:
            nb = min(batch, n_packets - done)
            key, sub = jax.random.split(key)
            p, l_, f, n_ = _tbcc_bler_batch(spec, crc, sub, nb,
                                            payload_bits, list_size, ebn0)
            pb += int(p); lb += int(l_); fa += int(f); total += int(n_)
            done += nb
        point = {
            "ebn0_db": ebn0,
            "plain_bler": pb / total,
            "crc_list_bler": lb / total,
            "false_accept": fa / total,
            "blocks": total,
        }
        results.append(point)
        if verbose:
            print(json.dumps(point), flush=True)
    return results


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _turbo_bler_batch(key, n_blocks: int, L: int, E: int, n_iters: int,
                      ebn0_db):
    """One turbo batch over AWGN/BPSK.

    Returns (bit_errors, block_errors, false_accepts, n).  Eb/N0 is
    per message bit at code rate L/E (CRC24B counted as payload,
    matching the harness' stated convention).  (No "CRC rejects a
    correct block" counter: messages are built by crc_append, so a
    block equal to its message always passes — the event is
    structurally impossible in this harness.)
    """
    from ..ops import lte
    from ..ops.crc import CRC24B, crc_append, crc_check
    kmsg, kchan = jax.random.split(key)
    rate = L / E
    payload = jax.random.bernoulli(
        kmsg, 0.5, (n_blocks, L - 24)).astype(jnp.uint8)
    msgs = crc_append(CRC24B, payload)
    tx = lte.lte_turbo_encode_batch(msgs, E)
    rx = awgn(kchan, bpsk_modulate(tx), ebn0_db, rate)
    q = quantize_llrs(bpsk_llr(rx, ebn0_db, rate), qmax=31).astype(jnp.int32)
    dec, _ = lte.lte_turbo_decode(q, L, n_iters=n_iters)
    errs = dec != msgs
    blk = jnp.any(errs, axis=1)
    ok = crc_check(CRC24B, dec)
    return (jnp.sum(errs), jnp.sum(blk), jnp.sum(ok & blk), n_blocks)


def run_bler_curve_turbo(ebn0_points=None, *, L: int = 6144,
                         E: int | None = None, n_blocks: int = 2048,
                         batch: int = 256, n_iters: int = 6,
                         seed: int = 11, verbose: bool = True):
    """Measured BER/BLER curve for the LTE turbo chain over AWGN/BPSK
    (the `run_bler_curve_tbcc` analogue for the turbo code): CRC24B
    payloads, full 36.212 encode/rate-match/decode, CRC false-accept
    counting.  Defaults to the rate-1/3 L=6144 mother code.

    Returns a list of dicts, one per Eb/N0 point.
    """
    if E is None:
        E = 3 * (L + 4)
    if ebn0_points is None:
        ebn0_points = [0.0, 0.4, 0.8, 1.2]
    results = []
    for ebn0 in ebn0_points:
        key = jax.random.PRNGKey(seed)
        be = blk = fa = total = 0
        done = 0
        while done < n_blocks:
            nb = min(batch, n_blocks - done)
            key, sub = jax.random.split(key)
            b, k_, f, n_ = _turbo_bler_batch(sub, nb, L, E, n_iters, ebn0)
            be += int(b); blk += int(k_); fa += int(f)
            total += int(n_)
            done += nb
        point = {
            "ebn0_db": ebn0,
            "ber": be / (total * L),
            "bler": blk / total,
            "false_accept": fa / total,
            "blocks": total,
        }
        results.append(point)
        if verbose:
            print(json.dumps(point), flush=True)
    return results


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _harq_batch(key, n_blocks: int, L: int, E: int, rv_seq: tuple,
                n_iters: int, ebn0_db):
    """One HARQ batch: per transmission count, block errors for
    incremental redundancy (rv sequence) vs chase (rv 0 repeated).

    Returns (ir_blk [T], chase_blk [T], n).  Eb/N0 is per message bit
    PER TRANSMISSION (each retransmission adds energy — the HARQ
    working regime), rate L/E.
    """
    from ..ops import lte
    from ..ops.crc import CRC24B, crc_append
    from ..ops.turbo import RscSpec, turbo_decode_batch
    rsc = RscSpec()
    keys = jax.random.split(key, 2 * len(rv_seq) + 1)
    rate = L / E
    payload = jax.random.bernoulli(
        keys[0], 0.5, (n_blocks, L - 24)).astype(jnp.uint8)
    msgs = crc_append(CRC24B, payload)
    pi = tuple(int(p) for p in lte.lte_qpp(L))

    def decode(buf):
        fields = lte.turbo_demux_tails(jnp.clip(buf, -255, 255))
        bits, _ = turbo_decode_batch(rsc, *fields, perm=pi,
                                     n_iters=n_iters)
        return jnp.sum(jnp.any(bits != msgs, axis=1))

    ir = jnp.zeros((n_blocks, 3, L + 4), jnp.int32)
    ch = jnp.zeros((n_blocks, 3, L + 4), jnp.int32)
    ir_blk, ch_blk = [], []
    for t, rv in enumerate(rv_seq):
        for mode, rv_t in (("ir", rv), ("ch", rv_seq[0])):
            tx = lte.lte_turbo_encode_batch(msgs, E, rv=rv_t)
            kch = keys[1 + 2 * t + (mode == "ch")]
            rx = awgn(kch, bpsk_modulate(tx), ebn0_db, rate)
            q = quantize_llrs(bpsk_llr(rx, ebn0_db, rate),
                              qmax=31).astype(jnp.int32)
            add = lte.derate_match_turbo(q, L + 4, rv=rv_t)
            if mode == "ir":
                ir = ir + add
            else:
                ch = ch + add
        ir_blk.append(decode(ir))
        ch_blk.append(decode(ch))
    return jnp.stack(ir_blk), jnp.stack(ch_blk), n_blocks


def run_harq_ir_turbo(*, L: int = 1024, E: int | None = None,
                      ebn0_db: float = -4.5, rv_seq=(0, 2, 3, 1),
                      n_blocks: int = 1024, batch: int = 256,
                      n_iters: int = 6, seed: int = 13,
                      verbose: bool = True):
    """Measured HARQ evidence: BLER vs transmission count for 36.212
    incremental redundancy (redundancy versions `rv_seq` accumulated
    through `derate_match_turbo`) against chase combining (rv 0
    repeated) at the same per-transmission Eb/N0.  Each transmission
    carries E bits (default: heavily punctured, rate ~L/E per tx), so
    later rv rounds reveal fresh parity — the IR gain.

    Returns a list of dicts, one per transmission count.
    """
    if E is None:
        E = int(1.25 * L)
    ir = np.zeros(len(rv_seq), np.int64)
    ch = np.zeros(len(rv_seq), np.int64)
    total = 0
    key = jax.random.PRNGKey(seed)
    done = 0
    while done < n_blocks:
        nb = min(batch, n_blocks - done)
        key, sub = jax.random.split(key)
        i_, c_, n_ = _harq_batch(sub, nb, L, E, tuple(rv_seq), n_iters,
                                 ebn0_db)
        ir += np.asarray(i_); ch += np.asarray(c_); total += int(n_)
        done += nb
    results = []
    for t in range(len(rv_seq)):
        point = {
            "tx_count": t + 1,
            "rv": list(rv_seq[:t + 1]),
            "ir_bler": float(ir[t] / total),
            "chase_bler": float(ch[t] / total),
            "ebn0_db_per_tx": ebn0_db,
            "blocks": total,
        }
        results.append(point)
        if verbose:
            print(json.dumps(point), flush=True)
    return results


#: Oracle-pinned turbo acceptance constants — the berTestK7 pattern
#: (berTestK7/berTestK7.c:95-100, constants from MATLAB)
#: applied to the turbo chain: expected BER/BLER from the INDEPENDENT
#: C++ implementation (native/turbo_oracle.cpp, its own mt19937 RNG;
#: rate-1/3 E=3L+12, qmax=31 AGC quantizer, 6 max-log iterations with
#: 3/4 extrinsic scaling).  Keyed by (L, ebn0_db).  Waterfall points:
#: seed 9865, 20000 blocks at L=1024 / 6000 at L=6144.  TAIL points
#: ((1024, 1.0) and (6144, 0.7)) re-pinned by converged
#: campaigns with >= 1100 block-error events each (262,143 blocks at
#: L=1024, 163,839 at L=6144; 3 seed-sharded runs, seeds 9865-9867),
#: so per-side BLER sampling error is
#: ~3% and the 15% gate is meaningful at every gated point — matching
#: the reference's converged-statistics discipline.
TURBO_EXPECTED = {
    (1024, 0.5): {"ber": 1.6995e-2, "bler": 0.2997},
    (1024, 1.0): {"ber": 1.0654e-4, "bler": 4.299e-3},
    (6144, 0.4): {"ber": 9.3565e-3, "bler": 0.6497},
    (6144, 0.7): {"ber": 7.901e-6, "bler": 6.824e-3},
}


def run_turbo_acceptance(points=((1024, 0.5), (6144, 0.4)), *,
                         n_blocks: int = 4096, batch: int = 512,
                         tolerance: float = 0.15, n_iters: int = 6,
                         seed: int = 11, verbose: bool = True):
    """Statistical acceptance of the turbo chain against the
    independent-oracle constants: measured BER and BLER must fall
    within `tolerance` relative error of `TURBO_EXPECTED` (the
    reference gates at 10% relative on ~20 Mbit/point,
    berTestK7.c:167-172; the turbo gate defaults to 15% because block
    errors are burstier than bit errors).

    `points` entries are (L, ebn0_db) or (L, ebn0_db, n_blocks) —
    the 3-tuple form overrides `n_blocks` per point, sizing tail
    points for enough error events (every gated point must carry
    converged statistics, the berTestK7.c:95-100 discipline).

    Returns a list of dicts with a `passed` flag per point.
    """
    results = []
    for point in points:
        (L, ebn0), nb = point[:2], (point[2] if len(point) > 2
                                    else n_blocks)
        exp = TURBO_EXPECTED[(L, ebn0)]
        pt = run_bler_curve_turbo(
            ebn0_points=[ebn0], L=L, n_blocks=nb, batch=batch,
            n_iters=n_iters, seed=seed, verbose=False)[0]
        rel_ber = abs(pt["ber"] - exp["ber"]) / exp["ber"]
        rel_bler = abs(pt["bler"] - exp["bler"]) / exp["bler"]
        pt.update(L=L, expected_ber=exp["ber"], expected_bler=exp["bler"],
                  rel_err_ber=rel_ber, rel_err_bler=rel_bler,
                  passed=bool(rel_ber <= tolerance
                              and rel_bler <= tolerance))
        results.append(pt)
        if verbose:
            print(json.dumps(pt), flush=True)
    return results


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--tbcc":
        run_bler_curve_tbcc(
            ebn0_points=[float(a) for a in sys.argv[2:]] or None)
    elif len(sys.argv) > 1 and sys.argv[1] == "--turbo":
        run_bler_curve_turbo(
            ebn0_points=[float(a) for a in sys.argv[2:]] or None)
    elif len(sys.argv) > 1 and sys.argv[1] == "--harq":
        run_harq_ir_turbo()
    else:
        pts = [float(a) for a in sys.argv[1:]] or None
        run_curve(ebn0_points=pts)
