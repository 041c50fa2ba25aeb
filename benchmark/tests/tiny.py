"""The benchmark's cells at sizes a CPU test run holds: same code, same
channel and same control, fewer and shorter packets."""

from benchmark.harness import runner, spec

SIZES = {
    "k7_hard.bulk": ({"packet_bits": 64}, {"batch": 8, "buffers": 2,
                                           "sample_share": 0.5}),
    "wifi_r34_soft.bulk": ({"packet_bits": 120}, {"batch": 8, "buffers": 2,
                                                  "sample_share": 0.5}),
}

#: Sizes at which each cell's control reads wrong on the CPU: at 3% segment
#: corruption a 17-step decision depth departs from the whole-packet
#: decode some 10 to 25 times in 500,000 bits.
CONTROL_SIZES = {
    "k7_hard.bulk": ({"packet_bits": 2048}, {"batch": 256, "buffers": 1}),
    "wifi_r34_soft.bulk": ({"packet_bits": 1200}, {"batch": 16, "buffers": 1}),
}


def cell(name: str, sizes=SIZES):
    """(bench, cfg, traffic) of a cell at its tiny size."""
    bench = spec.load_benchmark()
    cfg, traffic = runner.load_cell(bench, name)
    c, t = sizes[name]
    return bench, {**cfg, **c}, {**traffic, **t}
