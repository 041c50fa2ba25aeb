"""Smoke coverage for the speed harness (C10/C11) on the CPU scan
path: the benches must run end-to-end at tiny scale and return a
positive rate."""

from convolutionalencdec.harness.speed import (
    bench_decode, bench_decode_ragged, bench_encode)


def test_bench_encode_smoke():
    assert bench_encode(batch=8, packet_bits=128, seconds=0.5) > 0


def test_bench_decode_smoke():
    assert bench_decode(batch=8, packet_bits=128, seconds=0.5) > 0


def test_bench_decode_ragged_smoke_mixed():
    assert bench_decode_ragged(batch=8, lengths=(128, 64),
                               seconds=0.5) > 0
