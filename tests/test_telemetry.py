"""Telemetry unit tests: describe, ThroughputMeter, traffic model.

The traffic model is analytic (SURVEY §5 tracing row); these tests pin
its invariants — decision traffic is 1 bit/state/step in every block
mode, the streaming path never round-trips decisions through HBM, and
the report renders one row per dispatchable mode.
"""

import pytest
import re

from convolutionalencdec.params import NASA_K7, TOY_K3
from convolutionalencdec.utils import (ThroughputMeter, describe,
                                           kernel_traffic, traffic_report)


def test_describe_mentions_parameters():
    text = describe(NASA_K7)
    assert "K=7" in text
    assert "0o133" in text and "0o171" in text
    assert "64" in text  # num_states


def test_kernel_traffic_decision_bytes():
    B, T = 2048, 2048
    NS = NASA_K7.num_states
    dec = T // 8 * NS * B
    for mode in ("block", "block_soft", "ragged"):
        r = kernel_traffic(NASA_K7, B, T, mode)
        assert r["forward_write_bytes"] >= dec
        assert r["traceback_read_bytes"] >= dec
        assert r["total_bytes"] == (
            r["forward_read_bytes"] + r["forward_write_bytes"]
            + r["traceback_read_bytes"] + r["traceback_write_bytes"]
            + r["glue_bytes"])
        assert r["decoded_bits"] == (T - NASA_K7.S) * B


def test_kernel_traffic_stream_no_decision_roundtrip():
    r = kernel_traffic(NASA_K7, 2048, 2048, "stream")
    assert r["traceback_read_bytes"] == 0
    assert r["traceback_write_bytes"] == 0
    # Streaming is the low-traffic mode by an order of magnitude.
    blk = kernel_traffic(NASA_K7, 2048, 2048, "block")
    assert r["bytes_per_decoded_bit"] < blk["bytes_per_decoded_bit"] / 5


def test_kernel_traffic_k_scaling():
    # decoded_bits must scale with k — use a k=2 spec so a dropped k
    # factor actually fails (TOY_K3 has k=1, which can't detect it).
    from convolutionalencdec.params import CodeSpec
    k2 = CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13))
    r = kernel_traffic(k2, 256, 256, "block")
    assert r["decoded_bits"] == (256 - k2.S) * 256 * 2
    r1 = kernel_traffic(TOY_K3, 256, 256, "block")
    assert r1["decoded_bits"] == (256 - TOY_K3.S) * 256


def test_kernel_traffic_ragged_mask_overhead():
    """Ragged adds only the per-channel start/end/emit vectors (three
    int32 per channel) on top of the block path, so mixed-length
    batching is essentially free."""
    blk = kernel_traffic(NASA_K7, 2048, 2048, "block")
    rag = kernel_traffic(NASA_K7, 2048, 2048, "ragged")
    assert rag["traceback_read_bytes"] == blk["traceback_read_bytes"] + 12 * 2048
    assert rag["total_bytes"] - blk["total_bytes"] < blk["total_bytes"] * 0.05


def test_kernel_traffic_unknown_mode():
    with pytest.raises(ValueError):
        kernel_traffic(NASA_K7, 8, 8, "warp")


def test_traffic_report_renders_all_modes():
    text = traffic_report(NASA_K7, 2048, 2054)
    for mode in ("block", "block_soft", "ragged", "stream"):
        # row-anchored: a bare substring check would let "block" ride
        # on the "block_int32" row's text.
        assert re.search(rf"^\s*{mode}\b", text, re.M), mode


def test_throughput_meter_accumulates():
    m = ThroughputMeter(report_every_s=0.0)
    line = m.tick(1_000_000)
    assert line is not None and "Mbit/s" in line
    assert m.average_mbps > 0
