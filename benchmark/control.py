"""Runs of a cell with its control in the program's place, on the chip.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 1]

For each seed, one whole run of the cell (set-up, a short window, the
check against the reference) in which the reference at the
configuration's control setting answers instead of the program.  Each
run has to read `correct` false; its compared numbers are the upper
readings the limits in `PERF.md` come from.  The benchmark's own runs
never run this.  One JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import device, runner, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    entry = spec.find(bench["workloads"], args.workload, "cell")
    device.setup_compile_cache()
    devices = device.require_chips(entry["chips"])
    cfg, traffic = runner.load_cell(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, lines = runner.run(bench, args.workload, cfg, traffic, seed,
                                   args.seconds, False, devices, t0,
                                   control=True)
        for line in lines:
            print(line, file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "checks": result["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
