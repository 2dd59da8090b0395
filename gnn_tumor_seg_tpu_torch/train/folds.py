"""Fold chunking, progress files, and the per-fold training loop.

Capability match for `utils/training_helpers.py`:
  - contiguous unshuffled folds that drop the len%k remainder (:26-31)
  - TSV progress file with a hyperparameter header (:7-23) and one row per
    fold x {train,val} (:34-36)
  - train_on_fold: checkpoint on best epoch loss, early-stop when loss exceeds
    best+1e-3 after half the epochs (:40-57)

Additions over the reference: a JSON-lines structured log next to each progress
file (step timing / throughput, SURVEY §5.5 build note).

A copy of gnn_tumor_seg_tpu/train/folds.py (the port imports nothing of the
JAX package): both packages write the same progress files.
"""

from __future__ import annotations

import json
import os
import time

__all__ = [
    "chunk_dataset_into_folds",
    "create_run_progress_file",
    "update_progress_file",
    "log_jsonl",
    "train_on_fold",
]


def _ensure_parent(fp: str) -> None:
    d = os.path.dirname(os.path.abspath(fp))
    if d:
        os.makedirs(d, exist_ok=True)


def chunk_dataset_into_folds(n_samples: int, k: int) -> list[tuple[int, int]]:
    fold_size = n_samples // k
    return [(i * fold_size, (i + 1) * fold_size) for i in range(k)]


def create_run_progress_file(fp: str, model_type: str, hp) -> None:
    _ensure_parent(fp)
    with open(fp, "w") as f:
        f.write("----Model Parameters----\n")
        f.write(f"Model\t{model_type}\n")
        f.write(f"Epochs\t{hp.n_epochs}\n")
        f.write(f"Input Features\t{hp.in_feats}\n")
        f.write(f"LR\t{hp.lr}\n")
        f.write(f"L2Reg\t{hp.w_decay}\n")
        f.write(f"LR Decay\t{hp.lr_decay}\n")
        f.write(f"Layer Sizes\t{hp.layer_sizes}\n")
        if model_type == "GAT":
            f.write(f"Heads\t{hp.gat_heads}\n")
            f.write(f"Residuals\t{hp.gat_residuals}\n")
        f.write("Fold\tLoss\tWT_Dice\tCT_Dice\tET_Dice\n\n")


def update_progress_file(fp: str, description: str, loss, dices) -> None:
    with open(fp, "a") as f:
        f.write(f"{description}\t{loss}\t{dices[0]}\t{dices[1]}\t{dices[2]}\n")


def log_jsonl(fp: str, record: dict) -> None:
    _ensure_parent(fp)
    record = {"ts": time.time(), **record}
    with open(fp, "a") as f:
        f.write(json.dumps(record) + "\n")


def train_on_fold(model, checkpoint_dir: str, n_epochs: int, run_name: str,
                  fold: int, log_fp: str | None = None,
                  val_loss_fn=None) -> None:
    """Run n_epochs epochs on `model` (a trainer exposing run_epoch() and
    save_weights(dir, name)); checkpoint on best loss; early-stop on converged
    loss after half the epochs.

    val_loss_fn (optional, no reference counterpart — it early-stops on TRAIN
    loss only, `utils/training_helpers.py:48-51`): a zero-arg callable
    returning a validation loss; when given, checkpointing and early-stop
    select on it instead of the train loss (e.g. a halo run's device-side
    HaloTrainer.evaluate_loss over the val partition)."""
    lowest_loss = 1000.0
    for i in range(1, n_epochs + 1):
        t0 = time.time()
        epoch_loss = float(model.run_epoch())
        dt = time.time() - t0
        select_loss = float(val_loss_fn()) if val_loss_fn else epoch_loss
        print(f"____Epoch {i}_____")
        print(epoch_loss)
        if log_fp:
            record = {"event": "epoch", "run": run_name, "fold": fold,
                      "epoch": i, "loss": epoch_loss, "seconds": dt}
            if val_loss_fn:
                record["val_loss"] = select_loss
            record.update(getattr(model, "last_epoch_stats", {}))
            log_jsonl(log_fp, record)
        if i > n_epochs / 2 and select_loss > lowest_loss + 0.001:
            print("Fold terminated early due to converged "
                  + ("val" if val_loss_fn else "train") + " loss")
            print(f"Ran for {i} epochs")
            return
        if select_loss < lowest_loss:
            lowest_loss = select_loss
            model.save_weights(checkpoint_dir, f"{run_name}_f{fold}")
    print(f"Finished fold {fold} for run {run_name}")
