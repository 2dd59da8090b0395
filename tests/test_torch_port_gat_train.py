"""GAT through the port's checkpoints, trainer and entry points, against the
JAX package on the CPU.

  * checkpoints: a JAX GAT checkpoint loads in the port and the reverse,
    every leaf equal in JAX flatten order (attn_l, attn_r, bias, w[, w_res]
    per layer), the loaded model's logits within rtol/atol 1e-5 of the JAX
    forward;
  * trainer: two epochs of GNNTrainer("GAT") from the JAX trainer's
    parameters on the same SyntheticGraphDataset, batch 3 (the last batch
    padded with masked copies), "exact", JAX impl="dense": per-epoch losses
    within 1e-5, parameters within 1e-4, the evaluate vector equal (the
    loss entry within rtol 1e-5);
  * cli.train_gnn -m GAT on the CPU writes a GAT checkpoint that either
    package loads, and predict_single serves a GAT checkpoint written by
    the JAX package with the JAX labels (a voxel may differ only where the
    JAX CNN's logit margin is below 1e-4, as in test_torch_port_serve.py).
"""

import os

import jax
import numpy as np
import pytest

from gnn_tumor_seg_tpu.cli.common import load_cnn_from_checkpoint as jax_load_cnn
from gnn_tumor_seg_tpu.cli.common import load_gnn_from_checkpoint as jax_load_gnn
from gnn_tumor_seg_tpu.cli.predict_single import predict_single_mri as jax_predict
from gnn_tumor_seg_tpu.config import HyperParams as JaxHyperParams
from gnn_tumor_seg_tpu.data.synthetic import SyntheticGraphDataset as JaxSynthetic
from gnn_tumor_seg_tpu.data.synthetic import random_graph
from gnn_tumor_seg_tpu.models.gat import GAT as JaxGAT
from gnn_tumor_seg_tpu.models.refine_cnn import CnnRefinementNet as JaxCnn
from gnn_tumor_seg_tpu.ops.graph import graph_from_arrays as jax_graph_from_arrays
from gnn_tumor_seg_tpu.ops.pallas.precision import precision_scope as jax_precision
from gnn_tumor_seg_tpu.train.checkpoint import load_checkpoint as jax_load
from gnn_tumor_seg_tpu.train.checkpoint import save_checkpoint as jax_save
from gnn_tumor_seg_tpu.train.gnn_trainer import GNNTrainer as JaxTrainer
from gnn_tumor_seg_tpu_torch.cli import predict_single as port_cli
from gnn_tumor_seg_tpu_torch.cli import train_gnn
from gnn_tumor_seg_tpu_torch.cli.common import (load_cnn_from_checkpoint,
                                                load_gnn_from_checkpoint)
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.convert import gat_params_to_jax
from gnn_tumor_seg_tpu_torch.data import nifti, store
from gnn_tumor_seg_tpu_torch.data.graph_build import GraphSample
from gnn_tumor_seg_tpu_torch.data.synthetic import (SyntheticGraphDataset,
                                                    make_synthetic_sample)
from gnn_tumor_seg_tpu_torch.models.gat import GAT
from gnn_tumor_seg_tpu_torch.ops.graph import graph_from_arrays
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from gnn_tumor_seg_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer
from tests.test_pipeline_e2e import SHAPE, make_fake_brats_dir

GAT_HP = dict(layer_sizes=[8, 8], gat_heads=[3, 2], gat_residuals=[False, True])


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def _jax_gat(hp):
    return JaxGAT(hp.in_feats, hp.layer_sizes, hp.out_classes,
                  heads=hp.gat_heads, residuals=hp.gat_residuals)


@pytest.mark.parametrize("residuals", [[False, True], [False, False]],
                         ids=["w_res", "no_res"])
def test_gat_checkpoints_cross_both_ways(tmp_path, residuals):
    hp = JaxHyperParams(**{**GAT_HP, "gat_residuals": residuals})
    jmodel = _jax_gat(hp)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    path = str(tmp_path / "jax_gat.ckpt")
    jax_save(path, jparams, "GAT", hp)
    model, port_hp, forward = load_gnn_from_checkpoint(path, device="cpu")
    assert isinstance(model, GAT) and port_hp.gat_heads == [3, 2]
    assert _leaves_equal(jparams, gat_params_to_jax(model))
    assert [list(layer.keys) for layer in model.layers][1] == (
        ["attn_l", "attn_r", "bias", "w", "w_res"] if residuals[1]
        else ["attn_l", "attn_r", "bias", "w"])

    rng = np.random.default_rng(0)
    feats, src, dst, _ = random_graph(rng, 90, avg_deg=4, f_dim=20)
    with jax_precision("exact"):
        want = np.asarray(jmodel.apply(jparams, jax_graph_from_arrays(feats, src, dst)))
    with precision_scope("exact"):
        got = forward(graph_from_arrays(feats, src, dst)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # the port writes, the JAX package reads
    ppath = str(tmp_path / "port_gat.ckpt")
    save_checkpoint(ppath, model, "GAT", HyperParams(**{**GAT_HP,
                                                         "gat_residuals": residuals}))
    back, model_type, jhp, manifest = jax_load(ppath, jmodel.init(jax.random.PRNGKey(0)))
    assert model_type == "GAT" and jhp.gat_residuals == residuals
    assert manifest["n_params"] == len(jax.tree_util.tree_leaves(jparams))
    assert _leaves_equal(back, jparams)
    leaves, *_ = load_checkpoint(ppath)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(leaves, jax.tree_util.tree_leaves(jparams)))


def test_gat_two_epochs_and_evaluate_match_jax():
    hp = dict(n_epochs=2, lr=3e-3, batch_size=3, **GAT_HP)
    jdata = JaxSynthetic(n_samples=7, grid=5, seed=3)
    data = SyntheticGraphDataset(n_samples=7, grid=5, seed=3)
    jt = JaxTrainer("GAT", JaxHyperParams(**hp), jdata, seed=0, impl="dense",
                    precision="exact")
    t = GNNTrainer("GAT", HyperParams(**hp), data, seed=0, precision="exact",
                   device="cpu")
    t.load_params(jax.tree_util.tree_map(np.asarray, jt.state.params))
    for _ in range(2):
        want, got = jt.run_epoch(), t.run_epoch()
        assert abs(got - want) <= 1e-5, (got, want)
    assert t.last_epoch_stats["steps"] == 3
    leaves = [p.detach().numpy() for p in t.model.jax_parameters()]
    for got, want in zip(leaves, jax.tree_util.tree_leaves(jt.state.params)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    with jax_precision("exact"):
        m_j, c_j = jt.evaluate(jdata, batch_size=3, workers=2)
    m_t, c_t = t.evaluate(data, batch_size=3, workers=2)
    np.testing.assert_allclose(m_t[0], m_j[0], rtol=1e-5)
    np.testing.assert_array_equal(m_t[1:], m_j[1:])
    np.testing.assert_array_equal(c_t, c_j)


def test_train_gnn_cli_trains_gat_on_the_cpu(tmp_path):
    root = tmp_path / "processed"
    rng = np.random.default_rng(0)
    for i in range(3):
        feats, src, dst, labels, sv, voxlab = make_synthetic_sample(rng, grid=4)
        d = root / f"brain_{i}"
        d.mkdir(parents=True)
        store.save_graph_npz(str(d / f"brain_{i}_graph.npz"), GraphSample(
            feats=feats, labels=labels, centroids=np.zeros((len(feats), 3)),
            src=src, dst=dst, sv_partition=None))
        nifti.save_as_nifti(sv, str(d / f"brain_{i}_supervoxels.nii.gz"))
        nifti.save_as_nifti(voxlab, str(d / f"brain_{i}_label.nii.gz"))
    out = str(tmp_path / "logs")
    train_gnn.main(["-d", str(root), "-o", out, "-r", "gat", "-m", "GAT", "-k", "1",
                    "--device", "cpu", "--hp", "n_epochs=2", "--hp",
                    "layer_sizes=[8, 8]", "--hp", "batch_size=3"])
    with open(os.path.join(out, "gat.txt")) as f:
        text = f.read()
    # the hardcoded heads and residuals; the two layers use the first two
    assert "Heads\t[4, 4, 3, 3]" in text
    assert "Residuals\t[False, False, True, False]" in text
    assert "\ngat_full\t" in text
    ckpt = os.path.join(out, "gat_f1.ckpt")
    hp = JaxHyperParams(layer_sizes=[8, 8], gat_heads=[4, 4, 3, 3],
                        gat_residuals=[False, False, True, False])
    jparams, model_type, _, manifest = jax_load(ckpt, _jax_gat(hp).init(
        jax.random.PRNGKey(0)))
    assert model_type == "GAT" and manifest["extra"]["epoch"] == 2
    model, _, _ = load_gnn_from_checkpoint(ckpt, device="cpu")
    assert _leaves_equal(jparams, gat_params_to_jax(model))


def test_predict_single_serves_a_gat_checkpoint(tmp_path):
    make_fake_brats_dir(tmp_path / "raw", n_samples=1, with_labels=False, seed=21)
    raw_case = next((tmp_path / "raw").iterdir())
    hp = JaxHyperParams(**GAT_HP)
    gnn_ckpt, cnn_ckpt = str(tmp_path / "gat.ckpt"), str(tmp_path / "cnn.ckpt")
    jax_save(gnn_ckpt, _jax_gat(hp).init(jax.random.PRNGKey(0)), "GAT", hp)
    jax_save(cnn_ckpt, JaxCnn(8, 4, [8]).init(jax.random.PRNGKey(8)), "CNN",
             JaxHyperParams(in_feats=8, layer_sizes=[8]))
    *_, jg = jax_load_gnn(gnn_ckpt)
    *_, jc = jax_load_cnn(cnn_ckpt)
    refined = {}

    def cnn_capture(x):
        out = jc(x)
        refined["logits"] = np.asarray(out)[0]
        return out

    with jax_precision("exact"):
        want = jax_predict(str(raw_case), jg, cnn_capture, num_nodes=250,
                           num_neighbors=6, cnn_prep="host")
    _, _, gfwd = load_gnn_from_checkpoint(gnn_ckpt, device="cpu")
    _, _, cfwd = load_cnn_from_checkpoint(cnn_ckpt, device="cpu")
    stages = {}
    with precision_scope("exact"):
        got = port_cli.predict_single_mri(str(raw_case), gfwd, cfwd,
                                          num_nodes=250, num_neighbors=6,
                                          stage_times=stages)
    assert got.shape == want.shape == SHAPE and got.dtype == np.int16
    assert set(np.unique(got)) <= {0, 1, 2, 4}
    differ = int((got != want).sum())
    top = np.sort(refined["logits"], axis=-1)
    assert differ == 0 or (top[..., -1] - top[..., -2]).min() < 1e-4, differ
