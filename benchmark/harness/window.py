"""The measured window and what every driver shares.

The closed loop is the program's `harness/speed.py` `_steady_loop`: one
call per distinct device-resident buffer, one `block_until_ready` per
round of buffers.  Its rate is all the work completed over all the time
of the window (the arithmetic of the program's
`ThroughputMeter.average_mbps`), never a best-of.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class Window:
    """What a window completed: `requests` requests carrying `bits`
    decoded message bits in `seconds`."""
    requests: int
    bits: int
    seconds: float


@dataclasses.dataclass
class Checks:
    """Numbers compared with the reference, each (value, limit); answers
    compared, and how many of them were wrong."""
    values: dict
    compared: int
    failed: int

    @property
    def correct(self) -> bool:
        return self.compared > 0 and all(v <= lim for v, lim in
                                         self.values.values())


def span(name: str, annotate: bool):
    """A host span in the profiler's trace, or nothing when not tracing."""
    return (jax.profiler.TraceAnnotation(name) if annotate
            else contextlib.nullcontext())


def keep_mask(seed: int, share: float, size: int = 1 << 20) -> np.ndarray:
    """Which calls of a window keep their answers for the check: a sample
    of `share` of them, drawn from the seed."""
    return np.random.default_rng(seed).random(size) < share


def closed_loop(call, bufs, bits_per_call: int, seconds: float, keep,
                annotate: bool):
    """Rounds of one call per buffer, each round ending in
    `block_until_ready`, until `seconds` have passed.  Returns the window
    and the kept answers `[(buffer, output)]`: those `keep` picks by call
    index, and the whole last round."""
    kept, calls = [], 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        round_out = []
        for j, x in enumerate(bufs):
            with span("bench.call", annotate):
                out = call(x)
            if calls < len(keep) and keep[calls]:
                kept.append((j, out))
            else:
                round_out.append((j, out))
            calls += 1
        with span("bench.wait", annotate):
            jax.block_until_ready(out)
        t = time.perf_counter()
        if t >= deadline:
            break
    return (Window(calls, calls * bits_per_call, t - t0),
            kept + round_out)


def mismatched_bits(got, want) -> int:
    """Bits that differ between two uint8 arrays of packed bytes or of
    0/1 bits of the same shape."""
    diff = jnp.bitwise_xor(jnp.asarray(got), jnp.asarray(want))
    return int(jnp.sum(jnp.unpackbits(diff), dtype=jnp.int32))
