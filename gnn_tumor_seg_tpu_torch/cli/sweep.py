"""CLI: random-hyperparameter sweep (counterpart of
gnn_tumor_seg_tpu/cli/sweep.py).

The reference's search workflow is "run the script multiple times in
parallel" with a time-seeded RNG (`README.md:120`,
`utils/hyperparam_helpers.py:50`). This CLI runs N independent trials of
`python -m gnn_tumor_seg_tpu_torch.cli.train_gnn ... --random_hyperparams`,
each with freshly sampled hyperparameters, one after another or as
parallel subprocesses, and ranks their progress files into a summary JSON.
Trial names embed the PID, so sweeps sharing an output directory never
collide. --device is passed to every trial.

  python -m gnn_tumor_seg_tpu_torch.cli.sweep -d <processed> -o <logs> -n 4 \\
      -m GSpool [-k K] [-j J] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..runtime import resolve_device

__all__ = ["main", "build_parser", "parse_progress_file", "score_trial",
           "trial_command"]


def parse_progress_file(fp: str):
    """-> list of (description, loss, wt, ct, et) rows from a run's TSV."""
    rows = []
    if not os.path.exists(fp):
        return rows
    with open(fp) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == 5 and parts[1] not in ("Loss",):
                try:
                    rows.append((parts[0], *(float(x) for x in parts[1:])))
                except ValueError:
                    continue
    return rows


def score_trial(fp: str) -> float | None:
    """Mean val-fold WT dice (falls back to all rows when no val rows exist)."""
    rows = parse_progress_file(fp)
    val = [r for r in rows if r[0].endswith("_val")] or rows
    if not val:
        return None
    return sum(r[2] for r in val) / len(val)


def trial_command(args, trial_name: str) -> list[str]:
    return [
        sys.executable, "-m", "gnn_tumor_seg_tpu_torch.cli.train_gnn",
        "-d", args.data_dir, "-o", args.output_dir, "-r", trial_name,
        "-m", args.model_type, "-k", str(args.num_folds),
        "--random_hyperparams", "--device", args.device,
    ]


def run_trial(args, trial_name: str) -> str:
    subprocess.run(trial_command(args, trial_name), check=False)
    return os.path.join(args.output_dir, f"{trial_name}.txt")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--data_dir", required=True, type=str)
    p.add_argument("-o", "--output_dir", required=True, type=str)
    p.add_argument("-m", "--model_type", default="GSpool", type=str)
    p.add_argument("-n", "--num_trials", default=4, type=int)
    p.add_argument("-k", "--num_folds", default=3, type=int)
    p.add_argument("-j", "--parallel", default=1, type=int,
                   help="concurrent trial subprocesses")
    p.add_argument("--name_prefix", default="sweep", type=str)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a GPU) or cpu, for "
                        "every trial")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    args.data_dir = os.path.expanduser(args.data_dir)
    args.output_dir = os.path.expanduser(args.output_dir)
    os.makedirs(args.output_dir, exist_ok=True)
    stamp = int(time.time())
    names = [f"{args.name_prefix}_{stamp}_{os.getpid()}_{i}"
             for i in range(args.num_trials)]

    if args.parallel <= 1:
        results = [(name, run_trial(args, name)) for name in names]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.parallel) as ex:
            results = list(zip(names, ex.map(lambda n: run_trial(args, n), names)))

    summary = [{"trial": name, "progress_file": fp, "val_wt_dice": score_trial(fp)}
               for name, fp in results]
    summary.sort(key=lambda r: -(r["val_wt_dice"] or -1))
    out_fp = os.path.join(args.output_dir, f"{args.name_prefix}_{stamp}_summary.json")
    with open(out_fp, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    print(f"Sweep summary written to {out_fp}")


if __name__ == "__main__":
    main()
