"""cli.train_gnn --parallel dp|halo on the CPU: the command starts two gloo
ranks itself (--mesh 2 --device cpu), rank 0 alone writes the progress file,
its JSON-lines log and the checkpoints, and a checkpoint serves through
load_gnn_from_checkpoint; so too with tensor parallelism (--parallel dp
--mesh 1,2); --parallel halo --mesh 2,2 is refused with the JAX CLI's
reason.

Each run is a child process in a session of its own with a deadline: on
expiry the whole session (the command and the ranks it spawned) is killed
and the test fails, so a hang costs one deadline.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu_torch.cli import train_gnn
from gnn_tumor_seg_tpu_torch.cli.common import load_gnn_from_checkpoint
from gnn_tumor_seg_tpu_torch.data import nifti, store
from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset
from gnn_tumor_seg_tpu_torch.data.graph_build import GraphSample
from gnn_tumor_seg_tpu_torch.data.synthetic import make_synthetic_sample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = ["--hp", "n_epochs=2", "--hp", "layer_sizes=[8]", "--hp",
             "batch_size=2"]
DEADLINE_S = 120


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


def _run_cli(args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gnn_tumor_seg_tpu_torch.cli.train_gnn", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"train_gnn {' '.join(args)} still running after "
                    f"{DEADLINE_S} s")
    assert proc.returncode == 0, err[-3000:]
    return out


def _rows(fp):
    with open(fp) as f:
        lines = f.read().splitlines()
    cut = lines.index("Fold\tLoss\tWT_Dice\tCT_Dice\tET_Dice")
    return [line.split("\t")[0] for line in lines[cut + 1:] if line]


@pytest.mark.parametrize("model_type,parallel,variant,k", [
    ("GSpool", "dp", None, 1),
    ("GAT", "halo", "p2p", 1),
    ("GSpool", "halo", "all_gather", 2),
], ids=["dp-GSpool", "halo-p2p-GAT", "halo-all_gather-GSpool-k2"])
def test_two_ranks_train_and_rank0_writes(data_dir, tmp_path, model_type,
                                          parallel, variant, k):
    out = str(tmp_path / "logs")
    args = ["-d", data_dir, "-o", out, "-r", "run", "-m", model_type,
            "-k", str(k), "--device", "cpu", "--parallel", parallel,
            "--mesh", "2", *OVERRIDES]
    if variant:
        args += ["--halo_variant", variant]
    stdout = _run_cli(args)
    if variant:
        assert f"variant={variant}" in stdout
    folds = ["full"] if k == 1 else [f"f{f}_{s}" for f in (1, 2)
                                      for s in ("train", "val")]
    assert _rows(os.path.join(out, "run.txt")) == [f"run_{f}" for f in folds]
    with open(os.path.join(out, "run.txt.jsonl")) as f:
        epochs = [line for line in f if '"event": "epoch"' in line]
    assert 1 <= len(epochs) <= 2 * k          # one line an epoch, rank 0 only
    ckpts = sorted(f for f in os.listdir(out) if f.endswith(".ckpt"))
    assert ckpts == [f"run_f{f}.ckpt" for f in range(1, k + 1)]
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    _, hp, fwd = load_gnn_from_checkpoint(os.path.join(out, "run_f1.ckpt"),
                                          device="cpu")
    g = ImageGraphDataset(data_dir, read_image=False).get_graph(0)
    logits = fwd(g)
    assert logits.shape == (1, g.num_nodes_padded, hp.out_classes)
    assert torch.isfinite(logits).all()


def test_tensor_parallel_mesh_is_refused(data_dir, tmp_path, capsys):
    """A model axis under --parallel halo is refused, as the JAX CLI does
    (gnn_tumor_seg_tpu/cli/train_gnn.py:271-273), before any rank starts."""
    with pytest.raises(SystemExit):
        train_gnn.main(["-d", data_dir, "-o", str(tmp_path), "-r", "r",
                        "--device", "cpu", "--parallel", "halo", "--mesh", "2,2"])
    err = capsys.readouterr().err
    assert ("--parallel halo partitions nodes over the data axis only; use "
            "--mesh D (n_model=1)") in err
    assert not os.path.exists(tmp_path / "r.txt")


@pytest.mark.parametrize("model_type", ["GSpool", "GAT"])
def test_tensor_parallel_dp_trains_and_rank0_writes(data_dir, tmp_path,
                                                    model_type):
    """--parallel dp --mesh 1,2: two model ranks, each with its column
    blocks (GAT: its heads); rank 0 writes one checkpoint of the whole
    model, which serves on one device."""
    out = str(tmp_path / "logs")
    _run_cli(["-d", data_dir, "-o", out, "-r", "run", "-m", model_type,
              "-k", "1", "--device", "cpu", "--parallel", "dp", "--mesh", "1,2",
              *OVERRIDES, "--hp", "gat_heads=[2]", "--hp", "gat_residuals=[False]"])
    assert _rows(os.path.join(out, "run.txt")) == ["run_full"]
    with open(os.path.join(out, "run.txt.jsonl")) as f:
        epochs = [line for line in f if '"event": "epoch"' in line]
    assert 1 <= len(epochs) <= 2
    assert sorted(f for f in os.listdir(out) if f.endswith(".ckpt")) == ["run_f1.ckpt"]
    model, hp, fwd = load_gnn_from_checkpoint(os.path.join(out, "run_f1.ckpt"),
                                              device="cpu")
    # whole leaves: the output layer's [in, 4] weight (GAT: 2 heads of 8 in)
    want = (8, 4) if model_type == "GSpool" else (16, 4)
    assert tuple(model.jax_parameters()[-1].shape) == want
    g = ImageGraphDataset(data_dir, read_image=False).get_graph(0)
    logits = fwd(g)
    assert logits.shape == (1, g.num_nodes_padded, hp.out_classes)
    assert torch.isfinite(logits).all()
