"""CLI: train the refinement CNN on saved GNN logits and images, on one device
(counterpart of gnn_tumor_seg_tpu/cli/train_refinement_cnn.py).

Argument contract of `scripts/train_refinement_cnn.py:64-90` and of the JAX
package's CLI, plus --device. One fix over the reference, kept from the JAX
package: the reference's k-fold loop trains every fold on the *full* image
dataset (a leak, `train_refinement_cnn.py:45` there); here each fold trains
only on its train split. Checkpoints (`<run>_f<fold>.ckpt`) and the
progress TSV (`<run>.txt`, with a JSON-lines log `<run>.txt.jsonl`) are in
the JAX package's formats.

  python -m gnn_tumor_seg_tpu_torch.cli.train_refinement_cnn -d <processed> \\
      -l <logits> -o <logs> -r run1 [-k K] [-x] [--precision exact|fast] \\
      [--hp KEY=VAL ...] [--device cuda|cpu]

Runs on the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import hardcoded_hyperparameters, random_hyperparameters
from ..data.dataset import ImageGraphDataset, PredLogitDataset
from ..runtime import resolve_device
from ..train import folds
from ..train.cnn_trainer import CNNTrainer
from .train_gnn import apply_hp_overrides

__all__ = ["main", "build_parser"]


class _ImageSubset:
    """The images of a fold's training split."""

    def __init__(self, base, indices):
        self.base = base
        self.ids = [base.ids[i] for i in indices]

    def __len__(self):
        return len(self.ids)

    def get_image(self, mri_id):
        return self.base.get_image(mri_id)

    def get_voxel_labels(self, mri_id):
        return self.base.get_voxel_labels(mri_id)


def document_metrics(fp, description, metrics):
    metrics = np.around(metrics, 4)
    print(f"\n#{description} Results#")
    print("Loss:", metrics[0])
    print(f"WT Voxel Dice: {metrics[1]}, CT Voxel Dice: {metrics[2]}, ET Voxel Dice: {metrics[3]}")
    print(f"WT HD95: {metrics[4]}, CT HD95: {metrics[5]}, ET HD95: {metrics[6]}")
    folds.update_progress_file(fp, description, metrics[0], metrics[1:4])


def _evaluate(model, ids, progress_fp, description):
    """evaluate() into the progress file, and its statistics (the prep
    cache's hits among them) into the JSON-lines log."""
    document_metrics(progress_fp, description, model.evaluate(ids))
    folds.log_jsonl(progress_fp + ".jsonl", {"event": "evaluate",
                                             "run": description,
                                             **model.last_eval_stats})


def train_on_full_dataset(args, hp, progress_fp, image_dataset, logit_dataset):
    print("Training on full dataset")
    model = CNNTrainer(hp, image_dataset, logit_dataset,
                       precision=args.precision, device=args.device)
    folds.train_on_fold(model, args.output_dir + os.sep, hp.n_epochs,
                        args.run_name, 1, log_fp=progress_fp + ".jsonl")
    _evaluate(model, image_dataset.ids, progress_fp, f"{args.run_name}_full")


def run_k_fold_val(args, hp, progress_fp, image_dataset, logit_dataset, k):
    n = len(image_dataset.ids)
    for fold_idx, (s, e) in enumerate(folds.chunk_dataset_into_folds(n, k)):
        val_ids = image_dataset.ids[s:e]
        train_idx = list(range(0, s)) + list(range(e, n))
        train_ids = [image_dataset.ids[i] for i in train_idx]
        print(f"Fold contains {len(train_ids)} examples")
        model = CNNTrainer(hp, _ImageSubset(image_dataset, train_idx),
                           logit_dataset, precision=args.precision,
                           device=args.device)
        fold = fold_idx + 1
        folds.train_on_fold(model, args.output_dir + os.sep, hp.n_epochs,
                            args.run_name, fold, log_fp=progress_fp + ".jsonl")
        model.image_dataset = image_dataset   # evaluate over the full dataset
        _evaluate(model, train_ids, progress_fp, f"{args.run_name}_f{fold}_train")
        _evaluate(model, val_ids, progress_fp, f"{args.run_name}_f{fold}_val")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--data_dir", required=True, type=str)
    p.add_argument("-l", "--saved_logit_dir", required=True, type=str,
                   help="directory holding <id>_logits.nii.gz from "
                        "generate_gnn_predictions -f logits")
    p.add_argument("-o", "--output_dir", required=True, type=str)
    p.add_argument("-r", "--run_name", required=True, type=str)
    p.add_argument("-k", "--num_folds", default=5, type=int)
    p.add_argument("-p", "--data_prefix", default="", type=str)
    p.add_argument("-x", "--random_hyperparams", action="store_true")
    p.add_argument("--precision", default="fast", choices=("exact", "fast"),
                   help="'fast' convolves in bf16 (the serving default); "
                        "'exact' in float32 with TF32 off")
    p.add_argument("--hp", action="append", default=[], metavar="KEY=VAL",
                   help="override a HyperParams field (Python-literal "
                        "values; repeatable), as for cli.train_gnn")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.num_folds < 1:
        parser.error("Number of folds must be a positive integer")
    args.device = resolve_device(args.device)
    image_dataset = ImageGraphDataset(os.path.expanduser(args.data_dir),
                                      args.data_prefix, read_image=True,
                                      read_graph=False, read_label=True)
    logit_dataset = PredLogitDataset(os.path.expanduser(args.saved_logit_dir))
    hp = (random_hyperparameters("CNN") if args.random_hyperparams
          else hardcoded_hyperparameters("CNN"))
    hp = apply_hp_overrides(hp, args.hp)
    args.output_dir = os.path.expanduser(args.output_dir)
    progress_fp = os.path.join(args.output_dir, f"{args.run_name}.txt")
    folds.create_run_progress_file(progress_fp, "CNN", hp)
    if args.num_folds == 1:
        train_on_full_dataset(args, hp, progress_fp, image_dataset, logit_dataset)
    else:
        run_k_fold_val(args, hp, progress_fp, image_dataset, logit_dataset,
                       args.num_folds)


if __name__ == "__main__":
    main()
