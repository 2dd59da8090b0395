#!/usr/bin/env python3
"""Time the GSpool and GSmean [256]*6 training steps of one checkout of the
PyTorch port on one NVIDIA H100, with that checkout's own chip_smoke.py.

Run from the repository root on a machine with the card:

    python3 scripts/torch_port_train_steps.py [--checkout DIR] [--models GSpool GSmean]

DIR (default: this checkout) is the root of a checkout of the repository,
for example a `git archive` of another commit unpacked under
results/scratch/ (which git ignores). Its package and its
chip_smoke.py are imported, its kernels built at first use, and its
training cell written (chip_smoke.write_train_data: 6 graphs of 7000
nodes, k=10, padded to 8192 x 12); then each model's step is timed by
chip_smoke.time_train_steps: the median of 8 steps in "exact" and in
"fast", and the device busy time and idle share over 3 more steps under
torch.profiler. Two checkouts are compared by running this script on each
in turn within one call (parent, change, change, parent). Prints the card
and, as its last line, one JSON object with each model's numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkout", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="root of the checkout to time")
    parser.add_argument("--models", nargs="+", default=["GSpool", "GSmean"],
                        choices=["GSpool", "GSmean", "GSgcn"])
    args = parser.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available; nothing was run", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset

    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise SystemExit(f"imported {cs.__file__}, not {root}/chip_smoke.py")
    card = cs.card_line()
    print(f"checkout {root}; card: {card}", flush=True)
    out = {"checkout": root, "card": card}
    with tempfile.TemporaryDirectory(prefix="gts_steps_") as tmp:
        data_dir = os.path.join(tmp, "train_data")
        cs.write_train_data(data_dir)
        dataset = ImageGraphDataset(data_dir, read_image=False)
        for model in args.models:
            steps = cs.time_train_steps(dataset, card, model)
            out[model] = {mode: {"step_ms": row["step_ms"],
                                 "step_ms_all": row["step_ms_all"],
                                 "busy_ms_3_steps": row["profile"]["busy_ms"],
                                 "idle_share": row["profile"]["idle_share"]}
                          for mode, row in steps.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
