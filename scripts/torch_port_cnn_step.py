#!/usr/bin/env python3
"""Time the refinement CNN's training step on the card under cuDNN settings.

    python3 scripts/torch_port_cnn_step.py [--setting NAME]

The step of train/cnn_trainer.CNNTrainer (forward, weighted CE, backward,
AdamW) of the hardcoded CNN (8 -> 16 -> 4, k=5) on random inputs at the
128^3 crop floor and at a 176x160x128 crop, "fast" and "exact". Each
setting runs in a process of its own, because cuDNN's algorithm cache is
shared by its benchmark and heuristic modes (whichever runs first on a
shape is kept):

  trainer     the trainer's own: cudnn.benchmark, and cudnn.deterministic
              under "exact" (CNNTrainer.compute_scope)
  heuristics  PyTorch's defaults: no benchmark, no deterministic
  benchmark   cudnn.benchmark, never deterministic
  fpad        the trainer's settings with F.pad(mode="replicate") in place
              of models/refine_cnn._replicate_pad (whose backward adds with
              atomics on CUDA)

Per setting, precision and shape: the median step ms over 8 steps after 2
(CUDA events), the first step's wall seconds (cuDNN's algorithm search),
and the largest parameter difference between two trainers from one seed
after 10 steps each (0 when the step repeats bitwise). With no --setting,
runs every setting in turn and prints one JSON line each, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = ("trainer", "heuristics", "benchmark", "fpad")
SHAPES = ((128, 128, 128), (176, 160, 128))
STEPS = 10


def run_setting(name: str) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, ROOT)
    from gnn_tumor_seg_tpu_torch.config import hardcoded_hyperparameters
    from gnn_tumor_seg_tpu_torch.models import refine_cnn
    from gnn_tumor_seg_tpu_torch.train.cnn_trainer import CNNTrainer, PreparedSample

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    if name == "fpad":
        refine_cnn._replicate_conv3d = lambda x, w, b: F.conv3d(
            F.pad(x, (2,) * 6, mode="replicate"), w, b)

    @contextlib.contextmanager
    def scope(trainer):
        if name in ("trainer", "fpad"):
            with trainer.compute_scope():
                yield
            return
        from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope

        torch.backends.cudnn.benchmark = name == "benchmark"
        torch.backends.cudnn.deterministic = False
        with precision_scope(trainer.precision):
            yield

    hp = hardcoded_hyperparameters("CNN")
    out = {}
    for shape in SHAPES:
        rng = np.random.default_rng(0)
        prep = PreparedSample(
            torch.from_numpy(rng.normal(size=(1, *shape, 8)).astype(np.float32)).cuda(),
            torch.from_numpy(rng.integers(0, 4, (1, *shape)).astype(np.int32)).cuda(),
            torch.ones((1, *shape), device="cuda"), None)
        for precision in ("fast", "exact"):
            a, b = (CNNTrainer(hp, seed=0, crop_floor=None, precision=precision)
                    for _ in range(2))
            times = []
            with scope(a):
                for i in range(STEPS):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    t = time.perf_counter()
                    start.record()
                    a._step(prep)
                    end.record()
                    end.synchronize()
                    if i == 0:
                        first_s = time.perf_counter() - t
                    if i >= 2:
                        times.append(start.elapsed_time(end))
                for _ in range(STEPS):
                    b._step(prep)
                torch.cuda.synchronize()
            diff = max(float((p - q).detach().abs().max()) for p, q in
                       zip(a.net.jax_parameters(), b.net.jax_parameters()))
            out["x".join(map(str, shape)) + f" {precision}"] = {
                "ms": statistics.median(times), "first_s": first_s,
                "two_runs_max_abs_diff": diff}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--setting", choices=SETTINGS)
    args = p.parse_args()
    if args.setting:
        print(json.dumps({args.setting: run_setting(args.setting)}), flush=True)
        return 0
    for name in SETTINGS:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--setting", name],
                       check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
