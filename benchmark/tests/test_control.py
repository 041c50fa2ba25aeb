"""A whole run of each cell with its control in the program's place (the
reference at the configuration's control setting) reads `correct` false
on three seeds, at sizes a CPU test run holds.  On the chip, at the
cells' own sizes: `python benchmark/control.py --workload <cell> --seeds a,b,c`."""

import time

import jax
import pytest

from benchmark.harness import runner, spec
from benchmark.tests import tiny


@pytest.mark.parametrize("name", list(tiny.CONTROL_SIZES))
def test_control_run_reads_not_correct(name):
    bench, cfg, traffic = tiny.cell(name, tiny.CONTROL_SIZES)
    chips = spec.find(bench["workloads"], name, "cell")["chips"]
    for seed in (11, 2 ** 31 + 3, 2 ** 40 + 17):
        result, lines = runner.run(bench, name, cfg, traffic, seed, 0.1,
                                   False, jax.devices()[:chips],
                                   time.perf_counter(), control=True)
        assert result["correct"] is False, (seed, lines)
        assert result["checks"]["mismatched_bits"]["value"] > 0, seed
