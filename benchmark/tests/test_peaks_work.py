import pytest

from benchmark.harness import peaks, work


def test_h100_peaks():
    p = peaks.peak("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["int32_ops_per_s"] == pytest.approx(16.7270e12, rel=1e-4)
    assert "white paper" in p["source"]


def test_unknown_device_is_an_error():
    with pytest.raises(KeyError, match="no published peaks"):
        peaks.peak("cpu")


def test_work_by_hand():
    # K=3: 4 states; 10 steps x 2 rows: 4 ops x 4 states x 20 = 320.
    assert work.acs_ops(10, 2, 3) == 320
    # 2 rows x (10 input bytes + ceil(8 / 8) message byte) = 22 bytes.
    assert work.decode_bytes(10, 2, 8) == 22
    assert work.decode_bytes(10, 2, 9) == 24
    # The bulk hard cell: 4 x 2054 x 2048 x 64 operations.
    w = work.decode_work(2054, 2048, 7, 2054, 2048)
    assert w == {"ops": 1_076_887_552, "bytes": 2048 * (2054 + 256)}


def test_least_seconds_names_its_bound():
    kind = "NVIDIA H100 80GB HBM3"
    t, bound = peaks.least_seconds(1_076_887_552, 2048 * 2310, kind)
    assert bound == "int32"
    assert t == pytest.approx(1_076_887_552 / (64 * 132 * 1.98e9))
    t, bound = peaks.least_seconds(1, 3.35e12, kind, chips=4)
    assert (bound, t) == ("hbm", pytest.approx(0.25))
