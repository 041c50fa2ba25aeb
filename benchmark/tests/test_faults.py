"""A run whose timed path is broken underneath reads `correct` false: for
each fault a cell can have, at its tiny size on the CPU."""

import functools
import time

import jax
import pytest

from benchmark.drivers import bulk
from benchmark.harness import runner, spec
from benchmark.tests import tiny

SEED = 2 ** 33 + 5


def half_batch(out):
    """The second half of the batch left out (never decoded)."""
    return out.at[out.shape[0] // 2:].set(0)


def altered(out):
    """One answer altered where it is produced: a single bit flipped."""
    return out.at[0, 0].set(out[0, 0] ^ 1)


def wrap_call(make, fault):
    @functools.wraps(make)
    def program(*args):
        made = make(*args)
        call, rest = made[0], made[1:]
        return (lambda x: fault(call(x)),) + rest
    return program


def run(name):
    bench, cfg, traffic = tiny.cell(name)
    chips = spec.find(bench["workloads"], name, "cell")["chips"]
    result, lines = runner.run(bench, name, cfg, traffic, SEED, 0.3, False,
                               jax.devices()[:chips], time.perf_counter())
    return result, lines


@pytest.mark.parametrize("name", ["k7_hard.bulk", "wifi_r34_soft.bulk"])
@pytest.mark.parametrize("fault", [half_batch, altered],
                         ids=["half_batch", "altered_answer"])
def test_bulk_faults(monkeypatch, name, fault):
    monkeypatch.setattr(bulk, "program", wrap_call(bulk.program, fault))
    result, lines = run(name)
    assert result["correct"] is False, lines
    assert result["checks"]["mismatched_bits"]["value"] > 0
