"""Runs one cell several times, one process per run as the check runs
them, and prints each metric's median and spread.

    python3 portbench/series.py --workload big.async_mem --seeds 11 12 13 \
        --seconds 50 [--trace 1] [--out series.jsonl]

Each run gets a ``TMPDIR`` of its own, and the bytes left in it after the
run are recorded (``tmp_bytes_left``) before it is removed.

The spread is the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median. Each
run's result line, exit code, seconds and the end of its standard error
go to ``--out`` as one JSON line.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run.py")


def spread(values) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--timeout", type=float, default=1200)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    values: dict = {}
    for seed in args.seeds:
        cmd = [sys.executable, RUN, "--workload", args.workload, "--seed", str(seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace)]
        tmp = tempfile.mkdtemp(prefix=f"series-{seed}-")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                              env={**os.environ, "TMPDIR": tmp})
        wall = time.perf_counter() - t0
        left = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp) for f in fs)
        shutil.rmtree(tmp, ignore_errors=True)
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        record = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": proc.returncode,
                  "wall_s": wall, "tmp_bytes_left": left, "result": result, "stderr_tail": proc.stderr[-3000:]}
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(record) + "\n")
        summary = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": proc.returncode, "wall_s": round(wall, 1),
                          "correct": (result or {}).get("correct"), **summary}), flush=True)
        if result is None:
            print(proc.stderr[-3000:], file=sys.stderr)
        for k, v in summary.items():
            values.setdefault(k, []).append(v)
    for k, vs in values.items():
        line = {"metric": k, "n": len(vs), "median": statistics.median(vs)}
        if len(vs) >= 2:
            line["spread"] = spread(vs)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
