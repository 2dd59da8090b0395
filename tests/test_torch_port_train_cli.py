"""cli.train_gnn on the CPU: k-fold and full-dataset runs, resume and profile
on a tiny preprocessed data directory written by the port's own store and
NIfTI writer; the progress file has the JAX package's header and rows, and
tensor parallelism (--mesh D,M, M > 1) is refused; -x draws the JAX package's
random configurations.
"""

import os

import numpy as np
import pytest

from gnn_tumor_seg_tpu.config import HyperParams as JaxHyperParams
from gnn_tumor_seg_tpu.config import random_hyperparameters as jax_random
from gnn_tumor_seg_tpu.train import folds as jax_folds
from gnn_tumor_seg_tpu_torch.cli import train_gnn
from gnn_tumor_seg_tpu_torch.config import random_hyperparameters
from gnn_tumor_seg_tpu_torch.data import nifti, store
from gnn_tumor_seg_tpu_torch.data.graph_build import GraphSample
from gnn_tumor_seg_tpu_torch.data.synthetic import make_synthetic_sample

OVERRIDES = ["--hp", "n_epochs=2", "--hp", "layer_sizes=[8]", "--hp",
             "batch_size=2"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("processed")
    rng = np.random.default_rng(0)
    for i in range(4):
        feats, src, dst, labels, sv, voxlab = make_synthetic_sample(rng, grid=4)
        mri_id = f"brain_{i}"
        d = root / mri_id
        d.mkdir()
        store.save_graph_npz(str(d / f"{mri_id}_graph.npz"), GraphSample(
            feats=feats, labels=labels, centroids=np.zeros((len(feats), 3)),
            src=src, dst=dst, sv_partition=None))
        nifti.save_as_nifti(sv, str(d / f"{mri_id}_supervoxels.nii.gz"))
        nifti.save_as_nifti(voxlab, str(d / f"{mri_id}_label.nii.gz"))
    return str(root)


def _rows(fp):
    with open(fp) as f:
        lines = f.read().splitlines()
    cut = lines.index("Fold\tLoss\tWT_Dice\tCT_Dice\tET_Dice")
    return lines[:cut + 1], [line.split("\t") for line in lines[cut + 1:] if line]


def test_k_fold_then_resume_full_dataset(data_dir, tmp_path):
    out = str(tmp_path / "logs")
    train_gnn.main(["-d", data_dir, "-o", out, "-r", "run", "-k", "2",
                    "--device", "cpu", *OVERRIDES])
    header, rows = _rows(os.path.join(out, "run.txt"))
    jax_fp = str(tmp_path / "jax.txt")
    jax_folds.create_run_progress_file(
        jax_fp, "GSpool", JaxHyperParams(n_epochs=2, layer_sizes=[8], batch_size=2))
    assert header == _rows(jax_fp)[0]
    assert [r[0] for r in rows] == ["run_f1_train", "run_f1_val",
                                    "run_f2_train", "run_f2_val"]
    assert all(len(r) == 5 and np.isfinite([float(x) for x in r[1:]]).all()
               for r in rows)
    for fold in (1, 2):
        assert os.path.exists(os.path.join(out, f"run_f{fold}.ckpt"))
    with open(os.path.join(out, "run.txt.jsonl")) as f:
        assert sum('"event": "epoch"' in line for line in f) == 4

    prof = str(tmp_path / "trace")
    train_gnn.main(["-d", data_dir, "-o", out, "-r", "full", "-k", "1",
                    "-m", "GSpool", "--device", "cpu", "--profile", prof,
                    "--resume_from", os.path.join(out, "run_f1.ckpt"), *OVERRIDES])
    _, rows = _rows(os.path.join(out, "full.txt"))
    assert [r[0] for r in rows] == ["full_full"]
    assert os.path.exists(os.path.join(out, "full_f1.ckpt"))
    assert any(name.endswith(".json") for name in os.listdir(prof))


@pytest.mark.parametrize("flag,says", [
    (["--parallel", "dp", "--mesh", "2,2", "--coordinator", "localhost:1",
      "--num_processes", "2", "--process_id", "0"],
     "--mesh 2,2 does not match --num_processes 2"),
    (["--mesh", "4"], "need --parallel dp or halo"),
    (["--num_processes", "2"], "need --parallel dp or halo")],
    ids=["flag0", "flag1", "flag2"])
def test_distribution_options_are_refused(data_dir, tmp_path, flag, says, capsys):
    """A mesh of D * M ranks that is not the world of --num_processes is
    refused before any rank joins; a mesh or the multi-process options
    without --parallel dp|halo mean nothing."""
    with pytest.raises(SystemExit):
        train_gnn.main(["-d", data_dir, "-o", str(tmp_path), "-r", "r",
                        "--device", "cpu", *flag])
    assert says in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "r.txt")


def test_gsgcn_trains_and_resume_needs_full_dataset(data_dir, tmp_path):
    out = str(tmp_path / "logs")
    train_gnn.main(["-d", data_dir, "-o", out, "-r", "gcn", "-m", "GSgcn", "-k", "1",
                    "--device", "cpu", *OVERRIDES])
    _, rows = _rows(os.path.join(out, "gcn.txt"))
    assert [r[0] for r in rows] == ["gcn_full"]
    with pytest.raises(SystemExit):
        train_gnn.main(["-d", data_dir, "-o", out, "-r", "x", "-k", "2",
                        "--device", "cpu",
                        "--resume_from", os.path.join(out, "gcn_f1.ckpt")])


@pytest.mark.parametrize("model_type", ["GSpool", "GAT", "CNN"])
def test_random_hyperparameters_match_jax(model_type):
    """-x draws the JAX package's configuration for the same seed (same
    distributions, same draw order)."""
    for seed in (0, 7, 123):
        assert (random_hyperparameters(model_type, seed).to_json()
                == jax_random(model_type, seed).to_json())
