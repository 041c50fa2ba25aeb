"""One run of one cell: set-up, the window (or a traced window), the check
against the reference, and the result line."""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time

import jax

from . import device, spec
from . import trace as trace_mod
from .window import Window


@dataclasses.dataclass
class Context:
    """What a metric's reader may read."""
    window: Window
    setup_s: float
    trace: trace_mod.Trace | None
    work: dict | None            # work of one request: {"ops", "bytes"}
    device_kind: str
    chips: int
    notes: list                  # lines for standard error


class CompileCounter:
    """Counts the programs JAX traces (and so compiles, or fetches from
    the cache) while it is entered: none should be inside a window."""
    EVENT = "/jax/core/compile/jaxpr_trace_duration"

    def __init__(self):
        self.count = 0

    def _listen(self, event, secs, **kwargs):
        if event == self.EVENT:
            self.count += 1

    def __enter__(self):
        jax.monitoring.register_event_duration_secs_listener(self._listen)
        return self

    def __exit__(self, *exc):
        jax.monitoring.unregister_event_duration_listener(self._listen)


def traced_window(cell, seconds: float, devices):
    """The cell's window under the profiler, reduced to a `Trace` of the
    devices the cell uses; the raw trace is deleted."""
    log_dir = tempfile.mkdtemp(prefix="bench_trace_")
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    try:
        jax.profiler.start_trace(log_dir, profiler_options=opts)
        try:
            with jax.profiler.TraceAnnotation(trace_mod.WINDOW_SPAN):
                win = cell.window(seconds, True)
        finally:
            jax.profiler.stop_trace()
        tr = trace_mod.load(log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    tr.devices = {d.id: tr.devices.get(d.id, []) for d in devices}
    return win, tr


def load_cell(bench: dict, cell_name: str) -> tuple[dict, dict]:
    """The configuration and the traffic mix of a cell."""
    entry = spec.find(bench["workloads"], cell_name, "cell")
    return (spec.load_config(bench, entry["config"]),
            spec.load_traffic(entry["traffic"]))


def run(bench: dict, cell_name: str, cfg: dict, traffic: dict, seed: int,
        seconds: float, traced: bool, devices, t0: float,
        control: bool = False) -> tuple[dict, list]:
    """Returns the result object and the lines for standard error (the
    compared numbers last).  With `control`, the cell's control (the
    reference at the configuration's control setting) takes the program's
    place in the window; its run has to read `correct` false."""
    cell = spec.driver(traffic["driver"]).Cell(cfg, traffic, seed, devices)
    if control:
        cell.use_control()
    cell.warm()
    setup_s = time.perf_counter() - t0

    tr = None
    with CompileCounter() as compiles:
        if traced:
            win, tr = traced_window(cell, traffic["trace_seconds"], devices)
        else:
            win = cell.window(seconds, False)
    peak = device.memory_peak_bytes(devices)
    work = cell.work()
    t_check = time.perf_counter()
    checks = cell.check()
    t_check = time.perf_counter() - t_check

    ctx = Context(win, setup_s, tr, work, devices[0].device_kind,
                  len(devices), [])
    metrics = {}
    group = "per_layer" if traced else "end_to_end"
    for m in spec.cell_metrics(bench, cell_name, group):
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": devices[0].platform, "kind": devices[0].device_kind,
           "count": jax.device_count(), "memory_peak_bytes": peak}
    result = {"correct": checks.correct, "attempted": win.requests,
              "failed": checks.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.mean_busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.values.items()}
    lines = ctx.notes + [
        f"{win.requests} requests in {win.seconds:.3f} s; "
        f"{checks.compared} answers compared, {checks.failed} wrong, "
        f"check {t_check:.3f} s; set-up {setup_s:.3f} s; "
        f"{compiles.count} programs traced in the window"]
    lines += [f"check {name}: {v} (limit {lim})"
              for name, (v, lim) in checks.values.items()]
    return result, lines
