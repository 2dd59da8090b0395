"""Hyperparameters and serve constants.

Copies of gnn_tumor_seg_tpu/config.py (HyperParams, hardcoded_hyperparameters,
random_hyperparameters, DEFAULT_BACKGROUND_NODE_LOGITS) and of the
standardization constants of
gnn_tumor_seg_tpu/data/preprocess.py: the port imports nothing of the JAX
package, and a checkpoint's embedded HyperParams JSON must read the same in
both packages.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "HyperParams",
    "hardcoded_hyperparameters",
    "random_hyperparameters",
    "DEFAULT_BACKGROUND_NODE_LOGITS",
    "STANDARDIZATION_STATS",
    "DEFAULT_MODALITY_EXTS",
]

DEFAULT_N_CLASSES = 4
DEFAULT_LR = 1e-4
DEFAULT_LR_DECAY = 0.98
DEFAULT_WEIGHT_DECAY = 1e-4
DEFAULT_FEATURE_DROPOUT = 0.0
DEFAULT_GNN_IN_FEATS = 20   # 5 quantiles x 4 modalities (mri2graph/graphgen.py:23-25)
DEFAULT_CNN_IN_FEATS = 8    # 4 modalities + 4 GNN logits (model/networks.py:16)

# Placeholder logits appended for background (-1) supervoxels when projecting node
# logits to voxels (`utils/hyperparam_helpers.py:25`).
DEFAULT_BACKGROUND_NODE_LOGITS = [[1.0, -1.0, -1.0, -1.0]]

# BraTS2021 healthy-tissue stats (per modality means/stds), as
# `preprocess_dataset.py:17,57` sets them.
STANDARDIZATION_STATS = (
    [0.4645, 0.6625, 0.4064, 0.3648],
    [0.1593, 0.1703, 0.1216, 0.1627],
)
DEFAULT_MODALITY_EXTS = ["_flair.nii.gz", "_t1.nii.gz", "_t1ce.nii.gz", "_t2.nii.gz"]


@dataclass
class HyperParams:
    n_epochs: int = 10
    in_feats: int = DEFAULT_GNN_IN_FEATS
    out_classes: int = DEFAULT_N_CLASSES
    lr: float = DEFAULT_LR
    lr_decay: float = DEFAULT_LR_DECAY
    w_decay: float = DEFAULT_WEIGHT_DECAY
    class_weights: list = field(default_factory=lambda: [0.1, 1, 2, 2])
    layer_sizes: list = field(default_factory=lambda: [256] * 4)
    feature_dropout: float = DEFAULT_FEATURE_DROPOUT
    gat_heads: list | None = None
    gat_residuals: list | None = None
    batch_size: int = 6          # graphs per GNN step (model/gnn_model.py:12)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "HyperParams":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def hardcoded_hyperparameters(model_type: str) -> HyperParams:
    """Default training configs (`utils/hyperparam_helpers.py:28-45`)."""
    if model_type == "CNN":
        return HyperParams(
            n_epochs=1,
            in_feats=DEFAULT_CNN_IN_FEATS,
            class_weights=[0.1, 5, 15, 15],
            layer_sizes=[16],
            batch_size=1,
        )
    hp = HyperParams(
        n_epochs=10,
        in_feats=DEFAULT_GNN_IN_FEATS,
        class_weights=[0.1, 1, 2, 2],
        layer_sizes=[256] * 4,
    )
    if model_type == "GAT":
        hp.gat_heads = [4, 4, 3, 3, 4, 4][: len(hp.layer_sizes)]
        hp.gat_residuals = [False, False, True, False, False, True][: len(hp.layer_sizes)]
    return hp


def random_hyperparameters(model_type: str, seed: int | None = None) -> HyperParams:
    """Random search distributions (`utils/hyperparam_helpers.py:48-72`),
    with the JAX package's draw order, so one seed gives the same config in
    both packages. Time-seeded (`time_ns() % 1000`) unless a seed is given,
    so that concurrent sweep runs differ; epoch counts use the reference's
    real values, not its leftover debug value of 3."""
    rng = np.random.RandomState(seed if seed is not None else time.time_ns() % 1000)
    lr = float(rng.choice([1e-4, 5e-4, 1e-3]))
    l2 = float(rng.choice([1e-4, 0.0]))
    if model_type == "CNN":
        hp = HyperParams(
            n_epochs=int(rng.choice([50, 100, 150])),
            in_feats=DEFAULT_CNN_IN_FEATS,
            lr=lr, w_decay=l2,
            class_weights=[0.1, float(rng.normal(5, 1)),
                           float(rng.normal(10, 2)), float(rng.normal(10, 2))],
            layer_sizes=[16],
            batch_size=1,
        )
    else:
        n_layers = int(rng.choice([3, 4, 5]))
        width = int(rng.choice([64, 128, 256]))
        hp = HyperParams(
            n_epochs=int(rng.choice([300, 400, 500])),
            in_feats=DEFAULT_GNN_IN_FEATS,
            lr=lr, w_decay=l2,
            class_weights=[0.1, float(rng.normal(1, 0.2)),
                           float(rng.normal(2, 0.2)), float(rng.normal(2, 0.2))],
            layer_sizes=[width] * n_layers,
        )
    # drawn for every model type: the reference consumes these values
    # whatever the model (`hyperparam_helpers.py:64-69`), and skipping them
    # would shift every later draw of a seeded sweep
    heads = (rng.randint(4, size=len(hp.layer_sizes)) + 3).tolist()
    residuals = [bool(x) for x in rng.binomial(1, p=0.3, size=len(hp.layer_sizes))]
    if model_type == "GAT":
        hp.gat_heads, hp.gat_residuals = heads, residuals
    return hp
