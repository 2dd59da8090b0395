"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`, each number compared for `correct` beside its limit.
The last lines of standard error repeat the checks. Without a CUDA device,
with fewer than the cell's chips, or when the process holds a module of
the JAX stack or of the JAX package once the window has closed, the run
prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card", file=sys.stderr)
        return 2
    from benchmark.harness import (forbidden_modules, load_benchmark, load_cell,
                                   run_cell)

    cell = load_cell(load_benchmark(ROOT), args.workload, ROOT)
    chips = int(cell.entry["chips"])
    if torch.cuda.device_count() < chips:
        print(f"cell {args.workload} needs {chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t_start=T_START,
                              root=ROOT)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds forbidden modules: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
