"""Whole runs of each cell at its tiny size on the CPU, past the look for
a chip: set-up, window, check and the result line."""

import json
import os
import subprocess
import sys
import time

import jax
import pytest

from benchmark.harness import runner, spec
from benchmark.tests import tiny

ROOT = spec.ROOT
SEED = 2 ** 31 + 977


def test_run_refuses_a_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "k7_hard.bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "needs an NVIDIA GPU" in p.stderr
    assert "{" not in p.stdout


def run_tiny(name, seed=SEED, seconds=0.3):
    bench, cfg, traffic = tiny.cell(name)
    chips = spec.find(bench["workloads"], name, "cell")["chips"]
    return runner.run(bench, name, cfg, traffic, seed, seconds, False,
                      jax.devices()[:chips], time.perf_counter())


@pytest.mark.parametrize("name", list(tiny.SIZES))
def test_tiny_run_is_correct(name):
    result, lines = run_tiny(name)
    assert result["correct"] is True, lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"mismatched_bits": {"value": 0, "limit": 0}}
    bench = spec.load_benchmark()
    want = {m["name"] for m in spec.cell_metrics(bench, name, "end_to_end")}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["device"]["platform"] == "cpu"
    assert lines[-1].startswith("check mismatched_bits: 0 (limit 0)")
    json.dumps(result)
