"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exit codes: 0 with a result; 2 when the card or the cell's cards are
missing; 3 when the run cannot give a result (JAX or the JAX package
loaded, a metric with nothing to read). The numbers compared for
``correct`` are also the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, CHECKOUT)
    # A library that would load JAX by itself is kept from doing so.
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from portbench import harness, registry

    bench = registry.benchmark()
    chips = registry.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             T_START, bench=bench)
    except harness.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        sign = ">=" if c.get("at_least") else "<="
        print(f"check {name} {c['value']!r} {sign} {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
