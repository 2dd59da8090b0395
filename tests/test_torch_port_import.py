"""The PyTorch port imports neither JAX nor any module of the JAX package.

Every module of gnn_tumor_seg_tpu_torch is imported in a fresh interpreter
in which importing `jax` or `gnn_tumor_seg_tpu` fails, and one CPU training
epoch and evaluation of GSpool, of GAT and of the refinement CNN run there;
the interpreter must then hold no `jax` and no `gnn_tumor_seg_tpu` module. Importing must also build nothing: the
kernels are compiled at first use.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, json, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    # any import of jax or of the JAX package fails, lazy ones included
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gnn_tumor_seg_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import gnn_tumor_seg_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# one CPU training epoch and an evaluation of GSpool and of GAT, so the
# imports made inside functions on the training paths run too
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.data.synthetic import SyntheticGraphDataset
from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer
data = SyntheticGraphDataset(n_samples=2, grid=3, seed=0)
trainer = GNNTrainer("GSpool", HyperParams(layer_sizes=[4], batch_size=2), data,
                     device="cpu")
trainer.run_epoch()
trainer.evaluate(data)
gat = GNNTrainer("GAT", HyperParams(layer_sizes=[4], batch_size=2, gat_heads=[2],
                                    gat_residuals=[False]), data, device="cpu")
gat.run_epoch()
gat.evaluate(data)
# and of the refinement CNN, on one tiny image with a saved logit volume
import tempfile
import numpy as np
from gnn_tumor_seg_tpu_torch.data import nifti
from gnn_tumor_seg_tpu_torch.data.dataset import PredLogitDataset
from gnn_tumor_seg_tpu_torch.train.cnn_trainer import CNNTrainer

class Images:
    ids = ["a"]
    def get_image(self, i):
        return np.random.default_rng(0).normal(size=(8, 8, 8, 4)).astype(np.float32)
    def get_voxel_labels(self, i):
        return np.random.default_rng(1).integers(0, 4, (8, 8, 8)).astype(np.int16)

logit_dir = tempfile.mkdtemp()
logits = np.zeros((8, 8, 8, 4), np.float32)
logits[2:6, 2:6, 2:6, 1] = 5.0
nifti.save_as_nifti(logits, logit_dir + "/a_logits.nii.gz")
cnn = CNNTrainer(HyperParams(in_feats=8, layer_sizes=[4], batch_size=1), Images(),
                 PredLogitDataset(logit_dir), crop_floor=None, device="cpu")
cnn.run_epoch()
cnn.evaluate()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "gnn_tumor_seg_tpu"
             or m.startswith("gnn_tumor_seg_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    import json

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    expected = {
        "gnn_tumor_seg_tpu_torch.cli.predict_single",
        "gnn_tumor_seg_tpu_torch.cli.train_gnn",
        "gnn_tumor_seg_tpu_torch.cli.preprocess",
        "gnn_tumor_seg_tpu_torch.cli.warmup",
        "gnn_tumor_seg_tpu_torch.cli.train_refinement_cnn",
        "gnn_tumor_seg_tpu_torch.cli.generate_gnn_predictions",
        "gnn_tumor_seg_tpu_torch.cli.generate_joint_predictions",
        "gnn_tumor_seg_tpu_torch.cli.sweep",
        "gnn_tumor_seg_tpu_torch.train.cnn_trainer",
        "gnn_tumor_seg_tpu_torch.ops.slic_device",
        "gnn_tumor_seg_tpu_torch.data.preprocess",
        "gnn_tumor_seg_tpu_torch.ops.sddmm",
        "gnn_tumor_seg_tpu_torch.ops.kernels.slot_gather",
        "gnn_tumor_seg_tpu_torch.ops.kernels.weighted_sum",
        "gnn_tumor_seg_tpu_torch.ops.kernels.max_agg",
        "gnn_tumor_seg_tpu_torch.ops.kernels.sum_agg",
        "gnn_tumor_seg_tpu_torch.ops.kernels.fused_gat",
        "gnn_tumor_seg_tpu_torch.models.gat",
        "gnn_tumor_seg_tpu_torch.data.native",
        "gnn_tumor_seg_tpu_torch.data.cache",
        "gnn_tumor_seg_tpu_torch.data.dataset",
        "gnn_tumor_seg_tpu_torch.data.store",
        "gnn_tumor_seg_tpu_torch.data.synthetic",
        "gnn_tumor_seg_tpu_torch.evaluation",
        "gnn_tumor_seg_tpu_torch.train.checkpoint",
        "gnn_tumor_seg_tpu_torch.train.folds",
        "gnn_tumor_seg_tpu_torch.train.gnn_trainer",
        "gnn_tumor_seg_tpu_torch.train.losses",
        "gnn_tumor_seg_tpu_torch.train.optim",
        "gnn_tumor_seg_tpu_torch.convert",
    }
    assert expected <= set(result["modules"])


def test_entry_points_refuse_a_missing_gpu():
    """With no CUDA device, an entry point left at its default device raises
    instead of carrying on on the CPU."""
    import pytest
    import torch

    from gnn_tumor_seg_tpu_torch.runtime import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
