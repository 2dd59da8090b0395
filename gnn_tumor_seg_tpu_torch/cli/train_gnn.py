"""CLI: train a GNN on preprocessed supervoxel graphs (k-fold or full dataset)
on one device (counterpart of gnn_tumor_seg_tpu/cli/train_gnn.py).

Argument contract of `scripts/train_gnn.py:64-89` and of the JAX package's
CLI, single-device regime; k=1 trains on the full dataset. Checkpoints
(`<run>_f<fold>.ckpt`, with optimizer state) and the progress TSV
(`<run>.txt`, plus a JSON-lines log `<run>.txt.jsonl`) land in the output
directory, in the JAX package's formats.

  python -m gnn_tumor_seg_tpu_torch.cli.train_gnn -d <processed> -o <logs> -r run1 \\
      [-m GSpool|GSmean|GSgcn|GAT] [-k K] [-x] [--hp KEY=VAL ...] \\
      [--resume_from CKPT] [--profile DIR] [--device cuda|cpu]

Runs on the GPU unless --device cpu is given (then every aggregation and
GAT's fused attention take their plain PyTorch versions). Training runs in
precision mode "fast" unless GTS_PALLAS_PRECISION=exact, as for the JAX
package. The JAX package's distribution options (--parallel dp|halo,
--mesh, --halo_variant, --graphs_per_batch and the multi-host flags) are
accepted by the parser and refused: the port's distribution is still to
come (ROADMAP.md, modules to port, item "Distribution"). --impl has no
counterpart: the port has one aggregation per device, the kernels on CUDA
and their plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import os

import numpy as np
import torch

from ..config import hardcoded_hyperparameters, random_hyperparameters
from ..data.dataset import ImageGraphDataset
from ..runtime import resolve_device
from ..train import folds
from ..train.gnn_trainer import GNNTrainer

__all__ = ["main", "build_parser", "apply_hp_overrides", "document_metrics"]

# options of the JAX CLI that need the port's distribution (not yet ported)
_DISTRIBUTION_OPTIONS = {
    "parallel": "single", "mesh": None, "halo_variant": "p2p",
    "graphs_per_batch": None, "coordinator": None, "num_processes": None,
    "process_id": None,
}


class _SubsetView:
    """A view of a dataset restricted to given indices (a fold's training
    set). Shares the underlying cache and exposes the data protocol the
    trainer expects."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = list(indices)
        self.ids = [base.ids[i] for i in self.indices]

    def __len__(self):
        return len(self.indices)

    def get_graph(self, i):
        return self.base.get_graph(self.indices[i])

    def get_supervoxel_partitioning(self, mri_id):
        return self.base.get_supervoxel_partitioning(mri_id)

    def get_voxel_labels(self, mri_id):
        return self.base.get_voxel_labels(mri_id)

    def shape_budget(self):
        return self.base.shape_budget()


def apply_hp_overrides(hp, overrides):
    """Apply --hp KEY=VAL overrides (Python-literal values) to a HyperParams."""
    known = {f.name for f in dataclasses.fields(type(hp))}
    for item in overrides:
        key, _, val = item.partition("=")
        key = key.strip()
        if key not in known:
            raise SystemExit(f"--hp: unknown HyperParams field {key!r} "
                             f"(known: {sorted(known)})")
        try:
            parsed = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            parsed = val
        hp = dataclasses.replace(hp, **{key: parsed})
    return hp


def document_metrics(fp: str, description: str, results) -> None:
    """Pretty-print + progress-file row (`scripts/train_gnn.py:48-59`)."""
    metrics, counts = np.around(results[0], 4), results[1]
    print(f"\n#{description} Results#")
    print("Loss:", metrics[0])
    print("Predicted Node Counts:", counts[0:4])
    print("Label Node Counts:", counts[4:8])
    print(f"WT Node Dice: {metrics[1]}, CT Node Dice: {metrics[2]}, ET Node Dice: {metrics[3]}")
    print(f"WT Voxel Dice: {metrics[4]}, CT Voxel Dice: {metrics[5]}, ET Voxel Dice: {metrics[6]}")
    print(f"WT HD95: {metrics[7]}, CT HD95: {metrics[8]}, ET HD95: {metrics[9]}")
    folds.update_progress_file(fp, description, metrics[0], metrics[4:7])


def train_on_full_dataset(args, hp, progress_fp, dataset):
    print("Training on full dataset")
    all_idx = list(range(len(dataset)))
    model = GNNTrainer(args.model_type, hp, _SubsetView(dataset, all_idx),
                       device=args.device)
    if args.resume_from:
        print(f"Resuming from {args.resume_from}")
        model.restore(os.path.expanduser(args.resume_from))
    folds.train_on_fold(model, args.output_dir + os.sep, hp.n_epochs,
                        args.run_name, 1, log_fp=progress_fp + ".jsonl")
    document_metrics(progress_fp, f"{args.run_name}_full",
                     model.evaluate(dataset, all_idx))


def run_k_fold_val(args, hp, progress_fp, dataset, k):
    for fold_idx, (s, e) in enumerate(folds.chunk_dataset_into_folds(len(dataset), k)):
        val_idx = list(range(s, e))
        train_idx = list(range(0, s)) + list(range(e, len(dataset)))
        train_view = _SubsetView(dataset, train_idx)
        print(f"Fold contains {len(train_view)} examples")
        model = GNNTrainer(args.model_type, hp, train_view, device=args.device)
        fold = fold_idx + 1
        folds.train_on_fold(model, args.output_dir + os.sep, hp.n_epochs,
                            args.run_name, fold, log_fp=progress_fp + ".jsonl")
        document_metrics(progress_fp, f"{args.run_name}_f{fold}_train",
                         model.evaluate(dataset, train_idx))
        document_metrics(progress_fp, f"{args.run_name}_f{fold}_val",
                         model.evaluate(dataset, val_idx))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--data_dir", required=True, type=str)
    p.add_argument("-o", "--output_dir", required=True, type=str,
                   help="Log directory (weights + progress file)")
    p.add_argument("-r", "--run_name", required=True, type=str)
    p.add_argument("-m", "--model_type", default="GSpool", type=str,
                   help="GSpool, GSmean, GSgcn or GAT")
    p.add_argument("-k", "--num_folds", default=5, type=int,
                   help="k-fold validation folds; 1 = train on full dataset")
    p.add_argument("-p", "--data_prefix", default="", type=str)
    p.add_argument("-x", "--random_hyperparams", action="store_true")
    p.add_argument("--hp", action="append", default=[], metavar="KEY=VAL",
                   help="override a HyperParams field, e.g. --hp n_epochs=3 "
                        "--hp 'layer_sizes=[64,64]' (values are Python "
                        "literals; repeatable)")
    p.add_argument("--profile", default=None, type=str, metavar="DIR",
                   help="write a torch.profiler trace of the run into DIR "
                        "(a Chrome trace, for chrome://tracing or Perfetto)")
    p.add_argument("--resume_from", default=None, type=str,
                   help="checkpoint to resume training from (params + optimizer "
                        "state + epoch; full-dataset runs, -k 1)")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without a GPU) or cpu")
    # the JAX CLI's distribution options, refused until the port has them
    p.add_argument("--parallel", default="single",
                   choices=["single", "dp", "halo"])
    p.add_argument("--mesh", default=None, type=str, metavar="D[,M]")
    p.add_argument("--halo_variant", default="p2p",
                   choices=["p2p", "all_gather"])
    p.add_argument("--graphs_per_batch", default=None, type=int)
    p.add_argument("--coordinator", default=None, type=str, metavar="HOST:PORT")
    p.add_argument("--num_processes", default=None, type=int)
    p.add_argument("--process_id", default=None, type=int)
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    given = [name for name, default in _DISTRIBUTION_OPTIONS.items()
             if getattr(args, name) != default]
    if given:
        parser.error(
            f"{', '.join('--' + n for n in given)}: distributed training is "
            "not ported yet (ROADMAP.md, modules to port, 'Distribution'); "
            "this port trains on one device")
    if args.num_folds < 1:
        parser.error("Number of folds must be a positive integer")
    if args.resume_from and args.num_folds != 1:
        parser.error("--resume_from applies to full-dataset runs (-k 1)")
    args.device = resolve_device(args.device)
    dataset = ImageGraphDataset(os.path.expanduser(args.data_dir),
                                args.data_prefix, read_image=False,
                                read_graph=True, read_label=True)
    hp = (random_hyperparameters(args.model_type) if args.random_hyperparams
          else hardcoded_hyperparameters(args.model_type))
    hp = apply_hp_overrides(hp, args.hp)
    args.output_dir = os.path.expanduser(args.output_dir)
    progress_fp = os.path.join(args.output_dir, f"{args.run_name}.txt")
    folds.create_run_progress_file(progress_fp, args.model_type, hp)
    profiler = contextlib.nullcontext()
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if args.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                os.path.expanduser(args.profile)))
    with profiler:
        if args.num_folds == 1:
            train_on_full_dataset(args, hp, progress_fp, dataset)
        else:
            run_k_fold_val(args, hp, progress_fp, dataset, args.num_folds)


if __name__ == "__main__":
    main()
