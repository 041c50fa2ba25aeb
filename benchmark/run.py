"""Run one cell of the benchmark once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic and metrics are named in `BENCHMARK.json`
at the checkout's root.  With `--trace 0` the last line of standard output
is a JSON object with the cell's end-to-end metrics; with `--trace 1`, a
short traced window gives its per-layer metrics instead.  Without the
GPUs the cell asks for, it exits non-zero and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import device, runner, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = spec.load_benchmark()
    entry = spec.find(bench["workloads"], args.workload, "cell")
    device.setup_compile_cache()
    devices = device.require_chips(entry["chips"])
    identity = device.gpu_identity()
    cfg, traffic = runner.load_cell(bench, args.workload)
    result, lines = runner.run(bench, args.workload, cfg, traffic, args.seed,
                               args.seconds, bool(args.trace), devices, _T0)
    print(f"card: {identity}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
