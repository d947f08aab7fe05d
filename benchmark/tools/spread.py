"""The spread of a set of runs, from their result lines:

    python3 benchmark/tools/spread.py FILE.out [FILE.out ...]

Prints, for each metric, the median, the first and third quartiles
(statistics.quantiles(values, n=4)), the spread (Q3 - Q1) / median, and
the widest compared number of the output check beside its limit. A set's
files are the runs of one cell (tools/runs.sh writes one file a run).
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values) -> dict:
    q1, med, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return {"n": len(values), "median": med, "q1": q1, "q3": q3,
            "spread": (q3 - q1) / med if med else float("nan")}


def main(paths) -> None:
    lines = []
    for p in paths:
        with open(p) as f:
            text = f.read().strip().splitlines()
        if text:
            lines.append(json.loads(text[-1]))
    metrics = {}
    for line in lines:
        for k, m in line["metrics"].items():
            metrics.setdefault(k, []).append(m["value"])
    for k, vals in metrics.items():
        if len(vals) >= 2:
            print(k, json.dumps(spread(vals)), json.dumps(vals))
    checks = {}
    for line in lines:
        for k, c in line["checks"].items():
            checks.setdefault(k, []).append(c["value"])
    for k, vals in checks.items():
        print("check", k, "max", max(vals), "limit",
              lines[0]["checks"][k]["limit"])
    print("correct", [line["correct"] for line in lines],
          "failed", [line["failed"] for line in lines])


if __name__ == "__main__":
    main(sys.argv[1:])
