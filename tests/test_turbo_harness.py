"""Turbo harness runners (harness/curve.py): measured BLER curve and
HARQ incremental-redundancy evidence at CI scale."""

import numpy as np

from convolutionalencdec.harness.curve import (
    run_bler_curve_turbo, run_harq_ir_turbo)


def test_turbo_bler_curve_shape_and_sanity():
    pts = run_bler_curve_turbo(ebn0_points=[0.0, 2.5], L=104, E=3 * 108,
                               n_blocks=48, batch=24, n_iters=3,
                               verbose=False)
    assert [p["ebn0_db"] for p in pts] == [0.0, 2.5]
    # monotone: more SNR, fewer errors; high point essentially clean
    assert pts[1]["bler"] <= pts[0]["bler"]
    assert pts[1]["ber"] < 1e-2
    for p in pts:
        assert p["false_accept"] == 0.0
        assert p["blocks"] == 48


def test_harq_ir_beats_chase():
    pts = run_harq_ir_turbo(L=104, E=130, ebn0_db=-3.0, n_blocks=32,
                            batch=16, n_iters=3, verbose=False)
    assert [p["tx_count"] for p in pts] == [1, 2, 3, 4]
    ir = [p["ir_bler"] for p in pts]
    ch = [p["chase_bler"] for p in pts]
    assert all(a <= b + 1e-9 for a, b in zip(ir[1:], ir[:-1]))  # monotone
    # after the full rv cycle IR must strictly beat chase at this point
    assert ir[-1] < ch[-1]


def test_turbo_acceptance_ci_twin():
    """CI-scale twin of the oracle-anchored acceptance gate (the full
    gate is `run_turbo_acceptance` at >= 4096 blocks / 15%): reduced
    blocks, widened tolerance, L=1024 waterfall point only."""
    from convolutionalencdec.harness.curve import run_turbo_acceptance
    res = run_turbo_acceptance(points=((1024, 0.5),), n_blocks=256,
                               batch=128, tolerance=0.35,
                               verbose=False)
    assert res[0]["passed"], (res[0]["rel_err_ber"],
                              res[0]["rel_err_bler"])
