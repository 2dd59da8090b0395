"""The four steps of run_pipeline.sh on the port, against the JAX CLIs, on the CPU.

Module fixture: three fake BraTS brains (tests/test_pipeline_e2e.py,
32x32x24) in one directory preprocessed by the port's cli.preprocess
(250 supervoxels, k=6), as tests/test_cli_pipeline.py does with the JAX
CLI; a GSpool checkpoint trained by the JAX CLI (--hp for small widths).
GTS_CNN_CROP_FLOOR=none (tests/conftest.py).

Tolerances:
  * generate_gnn_predictions -f logits: the port's voxel logits within
    2**-14 of the logits' scale (largest magnitude) of the JAX CLI's. The
    JAX CLI runs its Pallas max kernel, whose "exact" mode carries each
    gathered value as two bf16 halves (~2**-16 relative; the bound of
    tests/test_torch_port_sage.py); measured 1.24e-5 absolute on logits of
    scale ~4. -f preds: labels bitwise equal;
  * generate_joint_predictions --precision exact with the same two
    checkpoints: labels bitwise equal to the JAX CLI's;
  * train_refinement_cnn: -k 1 and -k 2 run, write the JAX package's
    progress rows, and the checkpoint loads and restores in the JAX package
    bitwise;
  * scripts/run_pipeline_cuda.sh runs end to end with DEVICE=cpu;
  * the sweep parses and scores progress files as the JAX sweep does.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.cli import generate_gnn_predictions as jax_gnn_preds
from gnn_tumor_seg_tpu.cli import generate_joint_predictions as jax_joint
from gnn_tumor_seg_tpu.cli import sweep as jax_sweep
from gnn_tumor_seg_tpu.cli import train_gnn as jax_train_gnn
from gnn_tumor_seg_tpu.cli.common import load_cnn_from_checkpoint as jax_load_cnn
from gnn_tumor_seg_tpu.config import hardcoded_hyperparameters as jax_hardcoded
from gnn_tumor_seg_tpu.train.cnn_trainer import CNNTrainer as JaxCNNTrainer
from gnn_tumor_seg_tpu_torch.cli import (generate_gnn_predictions,
                                         generate_joint_predictions, preprocess,
                                         sweep, train_refinement_cnn)
from gnn_tumor_seg_tpu_torch.convert import cnn_params_to_jax
from gnn_tumor_seg_tpu_torch.data import nifti
from gnn_tumor_seg_tpu_torch.train.checkpoint import cnn_from_leaves, load_checkpoint
from tests.test_pipeline_e2e import SHAPE, make_fake_brats_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 2.0 ** -14          # of the logits' scale
GNN_HP = ["--hp", "n_epochs=2", "--hp", "layer_sizes=[16,16]", "--hp", "lr=3e-3",
          "--hp", "batch_size=2"]
CNN_HP = ["--hp", "n_epochs=2", "--hp", "layer_sizes=[8]", "--hp", "lr=1e-3"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_pipeline")
    make_fake_brats_dir(root / "raw", n_samples=3, seed=11)
    preprocess.main(["-d", str(root / "raw"), "-o", str(root / "proc"),
                     "-n", "250", "-k", "6", "-l", "_seg.nii.gz",
                     "--threads", "2"])
    jax_train_gnn.main(["-d", str(root / "proc"), "-o", str(root / "logs"),
                        "-r", "gnn", "-m", "GSpool", "-k", "1", *GNN_HP])
    return root


def _volumes(d, suffix, dtype):
    names = sorted(f for f in os.listdir(d) if f.endswith(suffix))
    return names, [nifti.read_nifti(os.path.join(d, f), dtype) for f in names]


@pytest.fixture(scope="module")
def logits(work):
    """Step 2 by both packages: the port's logit dir and the JAX CLI's."""
    gnn = str(work / "logs" / "gnn_f1.ckpt")
    for name, cli, extra in (("port", generate_gnn_predictions, ["--device", "cpu"]),
                             ("jax", jax_gnn_preds, [])):
        cli.main(["-d", str(work / "proc"), "-o", str(work / f"logits_{name}"),
                  "-w", gnn, "-f", "logits", *extra])
    return work / "logits_port", work / "logits_jax"


@pytest.fixture(scope="module")
def cnn_ckpt(work, logits):
    """Step 3 by the port, -k 1, on the port's logits."""
    train_refinement_cnn.main([
        "-d", str(work / "proc"), "-l", str(logits[0]), "-o", str(work / "logs"),
        "-r", "cnn", "-k", "1", "--precision", "exact", "--device", "cpu",
        *CNN_HP])
    return str(work / "logs" / "cnn_f1.ckpt")


def test_gnn_logits_and_preds_match_jax(work, logits):
    names, port = _volumes(logits[0], "_logits.nii.gz", np.float32)
    jnames, want = _volumes(logits[1], "_logits.nii.gz", np.float32)
    assert names == jnames and len(names) == 3
    for got, ref in zip(port, want):
        assert got.shape == ref.shape and got.shape[-1] == 4
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL * scale)
    gnn = str(work / "logs" / "gnn_f1.ckpt")
    generate_gnn_predictions.main(["-d", str(work / "proc"), "-o",
                                   str(work / "preds_port"), "-w", gnn,
                                   "-f", "preds", "--device", "cpu"])
    jax_gnn_preds.main(["-d", str(work / "proc"), "-o", str(work / "preds_jax"),
                        "-w", gnn, "-f", "preds"])
    names, port = _volumes(work / "preds_port", ".nii.gz", np.int16)
    assert names == _volumes(work / "preds_jax", ".nii.gz", np.int16)[0]
    for got, ref in zip(port, _volumes(work / "preds_jax", ".nii.gz", np.int16)[1]):
        assert got.shape == SHAPE and np.array_equal(got, ref)
        assert set(np.unique(got)) <= {0, 1, 2, 4}


def test_unknown_save_format_is_refused(work):
    with pytest.raises(ValueError, match="Unrecognized save format"):
        generate_gnn_predictions.main(["-d", str(work / "proc"), "-o",
                                       str(work / "bad"), "-w",
                                       str(work / "logs" / "gnn_f1.ckpt"),
                                       "-f", "bogus", "--device", "cpu"])


def test_cnn_checkpoint_loads_in_jax(work, cnn_ckpt):
    progress = (work / "logs" / "cnn.txt").read_text()
    assert "cnn_full\t" in progress
    leaves, model_type, hp, manifest = load_checkpoint(cnn_ckpt)
    assert model_type == "CNN" and hp.layer_sizes == [8]
    assert manifest["extra"]["epoch"] >= 1 and manifest["n_opt"] > 0
    want = cnn_params_to_jax(cnn_from_leaves(leaves))
    _, _, jhp, _ = jax_load_cnn(cnn_ckpt)
    jt = JaxCNNTrainer(jhp, seed=0, precision="exact")
    jt.restore(cnn_ckpt)
    for layer in ("conv0", "conv1"):
        for key in ("w", "b"):
            assert np.array_equal(np.asarray(jt.state.params[layer][key]),
                                  want[layer][key])
    assert int(jt.state.epoch) == manifest["extra"]["epoch"]


def test_cnn_k_fold_trains_each_fold(work, logits, tmp_path):
    train_refinement_cnn.main([
        "-d", str(work / "proc"), "-l", str(logits[0]), "-o", str(tmp_path),
        "-r", "kf", "-k", "2", "--device", "cpu", *CNN_HP])
    rows = [line.split("\t")[0] for line in
            (tmp_path / "kf.txt").read_text().splitlines() if line.startswith("kf_")]
    assert rows == ["kf_f1_train", "kf_f1_val", "kf_f2_train", "kf_f2_val"]
    assert (tmp_path / "kf_f1.ckpt").exists() and (tmp_path / "kf_f2.ckpt").exists()


def test_joint_predictions_match_jax(work, cnn_ckpt):
    gnn = str(work / "logs" / "gnn_f1.ckpt")
    argv = ["-d", str(work / "proc"), "-g", gnn, "-c", cnn_ckpt,
            "--precision", "exact"]
    generate_joint_predictions.main([*argv, "-o", str(work / "joint_port"),
                                     "--device", "cpu"])
    jax_joint.main([*argv, "-o", str(work / "joint_jax")])
    names, port = _volumes(work / "joint_port", ".nii.gz", np.int16)
    jnames, want = _volumes(work / "joint_jax", ".nii.gz", np.int16)
    assert names == jnames and len(names) == 3
    for got, ref in zip(port, want):
        assert got.shape == SHAPE
        assert set(np.unique(got)) <= {0, 1, 2, 4}
        assert np.array_equal(got, ref)


def test_joint_predictions_name_a_missing_file(work, cnn_ckpt, tmp_path):
    import shutil

    proc = tmp_path / "proc"
    shutil.copytree(work / "proc", proc)
    victim = sorted(os.listdir(proc))[0]
    os.remove(proc / victim / f"{victim}_crop.npy")
    with pytest.raises(FileNotFoundError, match=f"Couldnt predict {victim}"):
        generate_joint_predictions.main([
            "-d", str(proc), "-o", str(tmp_path / "out"),
            "-g", str(work / "logs" / "gnn_f1.ckpt"), "-c", cnn_ckpt,
            "--device", "cpu"])


def test_run_pipeline_cuda_sh_on_cpu(work, tmp_path):
    env = dict(os.environ, DEVICE="cpu",
               PROCESSED_TRAINING_DATA_DIR=str(work / "proc"),
               PROCESSED_TEST_DATA_DIR=str(work / "proc"),
               GNN_LOGIT_DIR=str(tmp_path / "logits"),
               PRED_OUTPUT_DIR=str(tmp_path / "preds"),
               LOG_OUTPUT_DIR=str(tmp_path / "logs"),
               GNN_EXTRA_ARGS="--hp n_epochs=1 --hp layer_sizes=[8]",
               CNN_EXTRA_ARGS="--hp n_epochs=1 --hp layer_sizes=[4]")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(["bash", os.path.join(ROOT, "scripts", "run_pipeline_cuda.sh")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "Finished Step 4" in proc.stdout
    assert len(os.listdir(tmp_path / "logits")) == 3
    names, preds = _volumes(tmp_path / "preds", ".nii.gz", np.int16)
    assert len(names) == 3
    assert all(p.shape == SHAPE and set(np.unique(p)) <= {0, 1, 2, 4}
               for p in preds)


def test_sweep_matches_jax(tmp_path):
    fp = tmp_path / "run.txt"
    fp.write_text("----Model Parameters----\nModel\tGSpool\n"
                  "Fold\tLoss\tWT_Dice\tCT_Dice\tET_Dice\n\n"
                  "r_f1_train\t0.5\t0.9\t0.8\t0.7\n"
                  "r_f1_val\t0.6\t0.7\t0.6\t0.5\n"
                  "r_f2_val\t0.4\t0.9\t0.5\t0.3\n"
                  "garbage\tline\n")
    assert sweep.parse_progress_file(str(fp)) == jax_sweep.parse_progress_file(str(fp))
    assert sweep.score_trial(str(fp)) == jax_sweep.score_trial(str(fp)) == \
        pytest.approx(0.8)
    assert sweep.score_trial(str(tmp_path / "missing.txt")) is None
    args = sweep.build_parser().parse_args(["-d", "D", "-o", "O", "-k", "2",
                                            "--device", "cpu"])
    cmd = sweep.trial_command(args, "t0")
    assert cmd[1:3] == ["-m", "gnn_tumor_seg_tpu_torch.cli.train_gnn"]
    assert "--random_hyperparams" in cmd
    assert cmd[cmd.index("--device") + 1] == "cpu"


def test_sweep_runs_a_trial_on_cpu(work, tmp_path, monkeypatch):
    """One trial end to end: the subprocess trains through the port's
    train_gnn (its random configuration cut to 1 epoch and width 8 by a
    stub) and the summary ranks it."""
    calls = []

    def fake_run(cmd, check):
        calls.append(cmd)
        from gnn_tumor_seg_tpu_torch.cli import train_gnn

        argv = [a for a in cmd[3:] if a != "--random_hyperparams"]
        train_gnn.main([*argv, "--hp", "n_epochs=1", "--hp", "layer_sizes=[8]"])

    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    sweep.main(["-d", str(work / "proc"), "-o", str(tmp_path), "-n", "1", "-k", "1",
                "--device", "cpu"])
    assert len(calls) == 1
    summary = [f for f in os.listdir(tmp_path) if f.endswith("_summary.json")]
    assert len(summary) == 1
    import json

    rows = json.loads((tmp_path / summary[0]).read_text())
    assert rows[0]["val_wt_dice"] is not None


CLIS = {
    "train_refinement_cnn": lambda w: train_refinement_cnn.main(
        ["-d", str(w / "proc"), "-l", str(w / "logits_port"), "-o", str(w / "x"),
         "-r", "x", "-k", "1"]),
    "generate_gnn_predictions": lambda w: generate_gnn_predictions.main(
        ["-d", str(w / "proc"), "-o", str(w / "x"), "-w",
         str(w / "logs" / "gnn_f1.ckpt"), "-f", "logits"]),
    "generate_joint_predictions": lambda w: generate_joint_predictions.main(
        ["-d", str(w / "proc"), "-o", str(w / "x"), "-g",
         str(w / "logs" / "gnn_f1.ckpt"), "-c", str(w / "logs" / "gnn_f1.ckpt")]),
    "sweep": lambda w: sweep.main(["-d", str(w / "proc"), "-o", str(w / "x")]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_entry_point_raises_without_a_gpu(work, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[name](work)
    assert not (work / "x").exists()


def test_cnn_hardcoded_config_matches_jax():
    from gnn_tumor_seg_tpu_torch.config import hardcoded_hyperparameters

    port, want = hardcoded_hyperparameters("CNN"), jax_hardcoded("CNN")
    assert (port.in_feats, port.layer_sizes, port.out_classes, port.class_weights) \
        == (want.in_feats, want.layer_sizes, want.out_classes, want.class_weights)
