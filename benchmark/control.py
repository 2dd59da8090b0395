"""Readings that set a cell's limits of `correct`: the program's numbers on
sound runs and the control's, the reference put in the program's place one
precision step below the cell's (reference/precision.py).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 3] [--fault NAME] [--out FILE]

Each program seed is one run of the cell with a short window at its own
load (every number judged as in a benchmark run); each control seed one
control of the same inputs. With --fault, the program seeds run with that
fault planted (faults.py), the readings that a fault gives. One JSON line a
reading, then a summary line:
per number the program's largest reading, the control's smallest, and
their ratio. Needs the card, like run.py; the benchmark's runs never run
the control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(name: str, seed: int, device="cuda", overrides=None,
                    root: str = ROOT) -> dict:
    """The compared numbers of the cell's control on `seed`."""
    import tempfile

    import torch

    from benchmark.harness import (Run, bench_dir, import_file, load_benchmark,
                                   load_cell)
    from benchmark.reference.precision import control_for
    from benchmark.trace import Tracer

    cell = load_cell(load_benchmark(root), name, root)
    kind = import_file(os.path.join(bench_dir(root), "kinds", f"{cell.traffic['kind']}.py"),
                       f"benchmark.kinds.{cell.traffic['kind']}")
    dev = torch.device(device)
    run = Run(cell, seed, 0.0, False, dev, Tracer(False, dev), tempfile.gettempdir(),
              dict(overrides or {}))
    return kind.control(run, control_for(run.param("precision")))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="program seeds, comma-separated")
    p.add_argument("--control-seeds", default="", help="control seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default=None, help="plant this fault (faults.py)")
    p.add_argument("--out", default=None, help="also append the lines to FILE")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import contextlib

    from benchmark.faults import planted
    from benchmark.harness import run_cell

    out = open(args.out, "a") if args.out else None

    def emit(line):
        s = json.dumps(line)
        print(s, flush=True)
        if out:
            out.write(s + "\n")
            out.flush()

    prog, ctrl = {}, {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        with planted(args.fault) if args.fault else contextlib.nullcontext():
            result, checks = run_cell(args.workload, seed, args.seconds, False)
        numbers = {k: c["value"] for k, c in checks.items()}
        emit({"workload": args.workload, "who": args.fault or "program", "seed": seed,
              "correct": result["correct"], "numbers": numbers,
              "metrics": result["metrics"], "s": time.perf_counter() - t})
        for k, v in numbers.items():
            prog[k] = max(prog.get(k, 0.0), v)
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t = time.perf_counter()
        numbers = control_numbers(args.workload, seed)
        emit({"workload": args.workload, "who": "control", "seed": seed,
              "numbers": numbers, "s": time.perf_counter() - t})
        for k, v in numbers.items():
            ctrl[k] = min(ctrl.get(k, float("inf")), v)
        torch.cuda.empty_cache()
    emit({"workload": args.workload, "summary": {
        k: {"program_max": prog.get(k), "control_min": ctrl.get(k),
            "ratio": (ctrl[k] / prog[k]) if prog.get(k) and k in ctrl else None}
        for k in sorted(set(prog) | set(ctrl))},
        "device": torch.cuda.get_device_name(0)})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
