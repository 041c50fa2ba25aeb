"""Reduction of a `jax.profiler` trace (`.xplane.pb`) to per-layer numbers.

Device planes (`/device:GPU:<i>`) hold the operations that ran on each
chip; the host plane holds the benchmark's own spans
(`jax.profiler.TraceAnnotation`, names starting with `bench.`) and JAX's
host events, on the same clock.  The traced window is the host span
`bench.window`; a trace without one (a recorded fixture) is windowed from
its first device operation to its last.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re

WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."
_DEVICE_PLANE = re.compile(r"^/device:[A-Z]+:(\d+)$")


@dataclasses.dataclass
class Trace:
    """Events as (name, start_ns, end_ns)."""
    devices: dict            # device index -> [(name, start, end)]
    host: list               # [(name, start, end)] on the host's threads
    window: tuple            # (start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def ops(self, device: int) -> list:
        """Device operations inside the window, clipped to it."""
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.devices[device]
                if e > lo and s < hi]

    def op_ns(self, device: int, match=None) -> float:
        """Summed device time of the operations `match(name)` accepts
        (all where None)."""
        return sum(e - s for n, s, e in self.ops(device)
                   if match is None or match(n))

    def op_count(self, device: int, match=None) -> int:
        return sum(1 for n, _, _ in self.ops(device)
                   if match is None or match(n))

    def busy_intervals(self, device: int) -> list:
        """Union of the device's operation intervals in the window."""
        out = []
        for _, s, e in sorted(self.ops(device), key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_ns(self, device: int) -> float:
        return sum(e - s for s, e in self.busy_intervals(device))

    def mean_busy_s(self) -> float:
        return sum(self.busy_ns(d) for d in self.devices) * 1e-9 / len(
            self.devices)

    def idle_share(self) -> float:
        """1 - busy / window, averaged over the devices."""
        return 1.0 - self.mean_busy_s() / self.window_s

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle gaps of every device in the window, each named
        by the host spans around its start: `[label, seconds]`."""
        gaps = []
        lo, hi = self.window
        for d in self.devices:
            t = lo
            for s, e in self.busy_intervals(d) + [[hi, hi]]:
                if s > t:
                    gaps.append((s - t, t))
                t = max(t, e)
        gaps.sort(reverse=True)
        return [[self.host_label(t), g * 1e-9] for g, t in gaps[:top]]

    def host_label(self, t: float) -> str:
        """The innermost benchmark span and the innermost other host event
        that cover time t, as `span/event`."""
        span, event = "none", "none"
        span_len = event_len = float("inf")
        for n, s, e in self.host:
            if s <= t < e:
                if n.startswith(SPAN_PREFIX):
                    if e - s < span_len:
                        span, span_len = n, e - s
                elif e - s < event_len:
                    event, event_len = n, e - s
        return f"{span}/{event}"

    def top_ops(self, top: int = 10) -> list:
        """Device operations that took most time, summed by name over the
        devices and averaged over them: `[name, seconds]`."""
        acc = {}
        for d in self.devices:
            for n, s, e in self.ops(d):
                acc[n] = acc.get(n, 0.0) + (e - s)
        ranked = sorted(acc.items(), key=lambda x: -x[1])[:top]
        return [[n, v * 1e-9 / len(self.devices)] for n, v in ranked]


def find_xplane(log_dir: str) -> str:
    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if len(paths) != 1:
        raise RuntimeError(f"expected one .xplane.pb under {log_dir}, "
                           f"found {len(paths)}")
    return paths[0]


def load(path: str) -> Trace:
    """Read an `.xplane.pb` file, or the one under a trace directory."""
    from jax.profiler import ProfileData
    if os.path.isdir(path):
        path = find_xplane(path)
    data = ProfileData.from_file(path)
    devices, host = {}, []
    for plane in data.planes:
        m = _DEVICE_PLANE.match(plane.name)
        if m:
            evs = devices.setdefault(int(m.group(1)), [])
            for line in plane.lines:
                for e in line.events:
                    evs.append((e.name, e.start_ns, e.start_ns + e.duration_ns))
        elif plane.name == "/host:CPU":
            for line in plane.lines:
                for e in line.events:
                    host.append((e.name, e.start_ns,
                                 e.start_ns + e.duration_ns))
    if not devices:
        raise RuntimeError(f"no device plane in {path}")
    spans = [(s, e) for n, s, e in host if n == WINDOW_SPAN]
    if spans:
        window = spans[0]
    else:
        starts = [s for evs in devices.values() for _, s, _ in evs]
        ends = [e for evs in devices.values() for _, _, e in evs]
        window = (min(starts), max(ends))
    return Trace(devices, host, window)


def name_matcher(names):
    """Match a kernel by its name, or by its name with a suffix that a
    compiler adds (`viterbi_acs_forward`, `viterbi_acs_forward_1`)."""
    names = tuple(names)
    return lambda n: any(n == k or n.startswith(k + "_") or n.startswith(k + ".")
                         for k in names)
