"""Metric readers, one file per metric of `BENCHMARK.json`, named after it.

Each has `read(ctx) -> float | None` (ctx: `harness.runner.Context`);
None where the run has nothing for it to read, and the metric is then
left out of the result line.
"""
