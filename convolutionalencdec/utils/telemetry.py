"""Telemetry: throughput metering and run configuration reporting.

The reference's observability is printf-based: each harness prints the
code parameters at startup (berTestK7.c:56-64) and the speed benches
print a Mbps line roughly once per second from timespec deltas wrapped in
compiler barriers (speedEncode.c:25-35,84-103).  The equivalents here:
`describe` renders a CodeSpec the same way, and `ThroughputMeter`
implements the steady-state Mbps loop around device computations (the
device-side `block_until_ready` plays the role of the reference's asm
barriers: nothing is counted until results are actually materialized).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..params import CodeSpec


def describe(spec: CodeSpec) -> str:
    """Human-readable code parameter block (cf. berTestK7.c:56-64)."""
    g_oct = ", ".join(f"0o{gi:o}" for gi in spec.g)
    lines = [
        f"Convolutional code: K={spec.K}, k={spec.k}, n={spec.n}, "
        f"Rc={spec.k}/{spec.n}",
        f"  generators (Proakis MSB-first): [{g_oct}]",
        f"  states: {spec.num_states}, traceback_len: {spec.traceback_len}",
        f"  butterfly/poly-symmetry eligible: {spec.has_poly_symmetry}",
    ]
    return "\n".join(lines)


@dataclass
class ThroughputMeter:
    """Steady-state throughput meter (cf. speedEncode.c:64-103).

    Usage:
        meter = ThroughputMeter()
        while ...:
            out = step(...)          # device computation
            out.block_until_ready()
            line = meter.tick(bits_processed)
            if line: print(line)
    """
    report_every_s: float = 1.0
    _t0: float = field(default=0.0, init=False)
    _bits: int = field(default=0, init=False)
    _total_bits: int = field(default=0, init=False)
    _start: float = field(default=0.0, init=False)

    def __post_init__(self):
        self._t0 = self._start = time.perf_counter()

    def tick(self, bits: int) -> str | None:
        """Account `bits`; returns a rate line once per report interval."""
        self._bits += bits
        self._total_bits += bits
        now = time.perf_counter()
        dt = now - self._t0
        if dt >= self.report_every_s:
            rate = self._bits / dt / 1e6
            self._t0 = now
            self._bits = 0
            return f"{rate:.2f} Mbit/s"
        return None

    @property
    def average_mbps(self) -> float:
        dt = time.perf_counter() - self._start
        return self._total_bits / dt / 1e6 if dt > 0 else 0.0


def kernel_traffic(spec: CodeSpec, batch: int, steps: int,
                   mode: str = "block") -> dict:
    """Analytic device-memory traffic of one decode call, in bytes and
    bytes per decoded bit (SURVEY §5 tracing row; per-kernel counters
    the reference never needed because its working set was
    cache-resident).

    Modes model the decoder core's paths (kernels/core.py):

    - "block": hard block decode.  The forward reads the time-major
      segments and writes the decisions (1 bit/state/step) and final
      metrics; the traceback reads the decisions and writes packed
      bytes.  "glue" is the XLA transpose of the segment batch into
      time-major order and of the output bytes back.
    - "block_soft": soft block decode: n int8 LLR planes in.
    - "ragged": "block" plus the per-channel start/end/emit vectors the
      traceback reads.
    - "stream": the per-step streaming decoder's carried state
      (metrics + W-deep survivor registers); decisions never leave it.

    Registers and on-chip caches are excluded.
    """
    NS = spec.num_states
    n = spec.n
    B, T = batch, steps
    dec_bytes = T // 8 * NS * B          # packed decisions, 1 bit/state/step
    bits_out = T // 8 * B                # packed decoded bits
    fm = NS * B * 4                      # final metrics, int32
    if mode in ("block", "ragged"):
        glue = 2 * T * B + 2 * bits_out
        fwd_r, fwd_w = T * B + fm, dec_bytes + fm
        tb_r, tb_w = dec_bytes, bits_out
        if mode == "ragged":
            tb_r += 3 * 4 * B
    elif mode == "block_soft":
        glue = 2 * n * T * B + 2 * bits_out
        fwd_r, fwd_w = n * T * B + fm, dec_bytes + fm
        tb_r, tb_w = dec_bytes, bits_out
    elif mode == "stream":
        state = NS * B * 4 + NS * spec.traceback_len * B
        glue = 0
        fwd_r, fwd_w = T * B + state, bits_out + state
        tb_r = tb_w = 0
    else:
        raise ValueError(f"unknown mode {mode!r}")
    total = fwd_r + fwd_w + tb_r + tb_w + glue
    decoded_bits = (T - spec.S) * B * spec.k
    return {
        "mode": mode,
        "forward_read_bytes": fwd_r,
        "forward_write_bytes": fwd_w,
        "traceback_read_bytes": tb_r,
        "traceback_write_bytes": tb_w,
        "glue_bytes": glue,
        "total_bytes": total,
        "bytes_per_decoded_bit": total / decoded_bits,
        "decoded_bits": decoded_bits,
    }


def traffic_report(spec: CodeSpec, batch: int, steps: int) -> str:
    """Render the per-kernel traffic table for all decode modes."""
    rows = [kernel_traffic(spec, batch, steps, m)
            for m in ("block", "block_soft", "ragged", "stream")]
    out = [f"Device-memory traffic per call (B={batch}, T={steps}, "
           f"K={spec.K}, NS={spec.num_states}):",
           f"  {'mode':11s} {'fwd R':>10s} {'fwd W':>10s} {'tb R':>10s} "
           f"{'tb W':>10s} {'glue':>10s} {'total':>11s} {'B/bit':>7s}"]
    for r in rows:
        out.append(
            f"  {r['mode']:11s} {r['forward_read_bytes']:>10,} "
            f"{r['forward_write_bytes']:>10,} {r['traceback_read_bytes']:>10,} "
            f"{r['traceback_write_bytes']:>10,} {r['glue_bytes']:>10,} "
            f"{r['total_bytes']:>11,} "
            f"{r['bytes_per_decoded_bit']:>7.2f}")
    return "\n".join(out)
