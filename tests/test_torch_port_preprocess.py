"""Dataset preprocessing: the port's cli.preprocess against the JAX
package's, and its device preprocessing flags.

Two synthetic labelled brains of 64x60x48 voxels (four int16 modalities and
a BraTS label volume) go through both CLIs with `-n 400 --weighted`. Both
run the same host code (the port's data modules are copies), so every
artifact must be bitwise equal: each array of `_graph.npz` (edge weights
included), the input, label and supervoxel volumes read back from NIfTI,
`_crop.npy` and `_meta.json`. Then the weighted store trains on the CPU
through the port's cli.train_gnn.
"""

import json
import os

import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.cli import preprocess as jax_cli
from gnn_tumor_seg_tpu_torch.cli import preprocess as port_cli
from gnn_tumor_seg_tpu_torch.cli import train_gnn
from gnn_tumor_seg_tpu_torch.data import nifti
from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset
from gnn_tumor_seg_tpu_torch.data.preprocess import DataPreprocessor
from gnn_tumor_seg_tpu_torch.ops.kernels import sum_agg, weighted_sum

SHAPE = (64, 60, 48)
MODALITIES = ("flair", "t1", "t1ce", "t2")


def _write_brain(folder, rng):
    """An ellipsoid brain with a three-class spherical tumour inside it."""
    os.makedirs(folder)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij"), -1)
    center = np.array(SHAPE) / 2 + rng.integers(-3, 4, 3)
    brain = np.linalg.norm((grid - center) / (np.array(SHAPE) / 2.4), axis=-1) < 1
    tumor = np.linalg.norm(grid - (center + rng.integers(-6, 7, 3)), axis=-1)
    labels = np.zeros(SHAPE, np.int16)
    for radius, cls in ((10, 2), (6, 1), (3, 4)):
        labels[(tumor < radius) & brain] = cls
    name = os.path.basename(folder)
    for m, mod in enumerate(MODALITIES):
        vol = np.zeros(SHAPE, np.int16)
        vol[brain] = 300 + 60 * m + rng.integers(0, 80, int(brain.sum()))
        vol[labels > 0] += 120 + 30 * m
        nifti.save_as_nifti(vol, os.path.join(folder, f"{name}_{mod}.nii.gz"))
    nifti.save_as_nifti(labels, os.path.join(folder, f"{name}_seg.nii.gz"))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_preprocess")
    rng = np.random.default_rng(0)
    for i in range(2):
        _write_brain(str(root / "raw" / f"BraTS_{i:03d}"), rng)
    args = ["-d", str(root / "raw"), "-n", "400", "-k", "10", "-l", "_seg.nii.gz",
            "--weighted", "--threads", "2"]
    jax_cli.main([*args, "-o", str(root / "jax")])
    port_cli.main([*args, "-o", str(root / "port")])
    return root


def test_preprocess_artifacts_match_jax(stores):
    ids = sorted(os.listdir(stores / "jax"))
    assert ids == ["BraTS_000", "BraTS_001"] == sorted(os.listdir(stores / "port"))
    for mri_id in ids:
        jdir, pdir = stores / "jax" / mri_id, stores / "port" / mri_id
        assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
        with np.load(jdir / f"{mri_id}_graph.npz") as j, \
                np.load(pdir / f"{mri_id}_graph.npz") as p:
            assert sorted(j.files) == sorted(p.files)
            assert "edge_weights" in p.files
            for key in j.files:
                assert j[key].dtype == p[key].dtype, key
                np.testing.assert_array_equal(p[key], j[key], err_msg=key)
            w = p["edge_weights"]
            assert len(w) == len(p["src"]) > 0 and (w > 0).all() and (w <= 1).all()
        for suffix in ("_input.nii.gz", "_label.nii.gz", "_supervoxels.nii.gz"):
            a = nifti.read_nifti(str(jdir / f"{mri_id}{suffix}"))
            b = nifti.read_nifti(str(pdir / f"{mri_id}{suffix}"))
            assert a.dtype == b.dtype and a.shape == b.shape, suffix
            np.testing.assert_array_equal(b, a, err_msg=suffix)
        jc = np.load(jdir / f"{mri_id}_crop.npy", allow_pickle=True)
        pc = np.load(pdir / f"{mri_id}_crop.npy", allow_pickle=True)
        assert len(jc) == len(pc) == 3
        for a, b in zip(jc, pc):
            np.testing.assert_array_equal(b, a)
        meta = json.loads((pdir / f"{mri_id}_meta.json").read_text())
        assert meta == json.loads((jdir / f"{mri_id}_meta.json").read_text())
        assert meta == {"orig_shape": list(SHAPE)}


def test_weighted_store_trains_on_the_cpu(stores, tmp_path):
    """The weighted store reaches the model: the dataset carries the edge
    weights and the reciprocal slots, and cli.train_gnn trains GSmean on it
    with a finite loss (plain versions on the CPU: no launch)."""
    data = ImageGraphDataset(str(stores / "port"), read_image=False)
    g = data.get_graph(0)
    assert g.edge_weight is not None and g.rslot is not None
    assert (g.edge_weight[g.nbr_mask == 0] == 0).all()
    before = (weighted_sum.weighted_sum.launches, sum_agg.sum_aggregate.launches)
    train_gnn.main(["-d", str(stores / "port"), "-o", str(tmp_path), "-r", "w",
                    "-m", "GSmean", "-k", "1", "--device", "cpu",
                    "--hp", "n_epochs=1", "--hp", "layer_sizes=[8]"])
    with open(tmp_path / "w.txt.jsonl") as f:
        epochs = [json.loads(line) for line in f if '"epoch"' in line]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["loss"])
    assert (weighted_sum.weighted_sum.launches,
            sum_agg.sum_aggregate.launches) == before
    assert torch.isfinite(torch.tensor(epochs[0]["loss"]))


@pytest.mark.parametrize("flags", [["--slic_impl", "tpu"],
                                   ["--prep_impl", "device"]])
def test_cli_device_preprocessing_matches_host(stores, tmp_path, flags):
    """The device preprocessing flags, refused before the chain was ported,
    now run on the two brains (--slic_impl tpu implies --prep_impl device):
    every sample's standardized input is bitwise the host path's, and its
    graph carries the edge weights of --weighted
    (tests/test_torch_port_slic_device.py compares the partitions)."""
    port_cli.main(["-d", str(stores / "raw"), "-o", str(tmp_path), "-n", "400",
                   "-k", "10", "-l", "_seg.nii.gz", "--weighted", "--threads",
                   "2", "--device", "cpu", *flags])
    ids = sorted(os.listdir(tmp_path))
    assert ids == ["BraTS_000", "BraTS_001"]
    for mri_id in ids:
        got, host = tmp_path / mri_id, stores / "port" / mri_id
        assert sorted(os.listdir(got)) == sorted(os.listdir(host))
        for suffix in ("_input.nii.gz", "_label.nii.gz"):
            np.testing.assert_array_equal(
                nifti.read_nifti(str(got / f"{mri_id}{suffix}")),
                nifti.read_nifti(str(host / f"{mri_id}{suffix}")), err_msg=suffix)
        with np.load(got / f"{mri_id}_graph.npz") as z:
            w = z["edge_weights"]
            assert len(w) == len(z["src"]) > 0 and (w > 0).all() and (w <= 1).all()
            assert len(z["feats"]) > 0 and bool(np.isfinite(z["feats"]).all())


def test_device_prep_impl_raises(tmp_path):
    """prep_impl='device' builds (on the CPU when asked); an unknown
    prep_impl still raises."""
    pre = DataPreprocessor(str(tmp_path), str(tmp_path / "out"),
                           prep_impl="device", device="cpu")
    assert pre.prep_impl == "device" and pre.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown prep_impl"):
        DataPreprocessor(str(tmp_path), str(tmp_path / "out"), prep_impl="gpu")
