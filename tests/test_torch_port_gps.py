"""GraphGPS in the port (models/gps.py) against the benchmark's plain
reference (benchmark/models/GPS.py, float64, on the union of the graphs),
on the CPU at small sizes with seeded weights. GPS has no JAX counterpart.

Tolerances, relative to the largest reference value:
  * "exact" float32 against float64: 1e-5 for logits and losses (float32
    keeps 24 bits, ~6e-8 a rounding; two layers of sums over a few hundred
    rows, BatchNorm divisions and softmaxes amplify it to ~1e-6), 1e-4 for
    gradients (the backward sums over every node and edge once more);
  * "fast" (bfloat16 activations) against float64: 0.06 for logits (8 bits
    of mantissa, 4e-3 a rounding, over ~40 rounded operations in two layers;
    the largest seen is 0.02);
  * padding: the same real rows with larger node and degree buckets within
    1e-6 in exact precision (only the order of float32 sums changes);
  * masked BatchNorm against torch's batch_norm over the real rows: 1e-6;
  * three AdamW steps through GNNTrainer, exact: the losses within 1e-5,
    the first gradient within 1e-4 and the parameters' change within 1e-3 of
    each leaf's reference norm (the median leaf's where larger), on the
    leaves that move (reference gradient above 1e-3 of the median leaf's;
    under Adam a leaf whose gradient is zero but for rounding, such as a
    bias a BatchNorm subtracts again, moves by round-off alone).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import inputs, weights
from benchmark.models import load as load_model
from benchmark.reference import train as ref_train
from benchmark.reference.precision import REFERENCE
from gnn_tumor_seg_tpu_torch import spans
from gnn_tumor_seg_tpu_torch.config import HyperParams, hardcoded_hyperparameters
from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
from gnn_tumor_seg_tpu_torch.models.gps import (GPS, MaskedBatchNorm,
                                                graph_attention)
from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs, graph_from_arrays
from gnn_tumor_seg_tpu_torch.ops.kernels import graph_attn
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from gnn_tumor_seg_tpu_torch.train import checkpoint
from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer
from gnn_tumor_seg_tpu_torch.train.optim import epoch_lr

CFG = {"model": "GPS", "in_feats": 20, "layer_sizes": [16, 16], "gps_heads": 2,
       "gps_post_layers": 3, "out_classes": 4}
SIZES = (50, 80, 64)
SEED = 2**31 + 21


def _hp(**kw):
    return HyperParams(in_feats=20, layer_sizes=[16, 16], gps_heads=2,
                       gps_post_layers=3, out_classes=4, **kw)


@pytest.fixture(scope="module")
def drawn():
    """The configuration's seeded weights and three graphs of unequal size
    (numpy COO, as the benchmark's training traffic makes them)."""
    ref = load_model("GPS")
    specs = ref.specs(CFG)
    gen = torch.Generator().manual_seed(SEED % 2**32)
    w = weights.draw(specs, gen)
    coo = [inputs.make_train_graph(gen, n, (6, 6, 6), 5, 20) for n in SIZES]
    return ref, specs, w, coo


def _model(specs, w) -> GPS:
    model = init_graph_net("GPS", _hp())
    weights.load_into(model.jax_parameters(), w, specs)
    return model


def _real_rows(out, coo):
    return torch.cat([out[b, :len(c[0])] for b, c in enumerate(coo)]).double()


def _reference_logits(ref, w, coo):
    feats, src, dst, _, graph = ref_train.union(coo, "cpu")
    with torch.no_grad():
        return ref.forward(CFG, w, feats, src, dst, graph, REFERENCE)


def test_leaf_order_is_the_references(drawn):
    ref, specs, w, _ = drawn
    model = init_graph_net("GPS", _hp())
    assert model.leaf_names() == [name for name, _, _ in specs]
    assert [tuple(p.shape) for p in model.jax_parameters()] == [s for _, s, _ in specs]
    # every parameter is a leaf, once; the last layer has no edge BatchNorm
    assert len(model.jax_parameters()) == len(list(model.parameters()))
    assert "l1.bn_e.g" not in model.leaf_names() and "l0.bn_e.g" in model.leaf_names()


@pytest.mark.parametrize("mode,tol", [("exact", 1e-5), ("fast", 0.06)])
def test_forward_matches_the_reference(drawn, mode, tol):
    ref, specs, w, coo = drawn
    model = _model(specs, w)
    batch = batch_graphs([graph_from_arrays(f, s, d, y, rslot=True)
                          for f, s, d, y in coo])
    want = _reference_logits(ref, w, coo)
    with precision_scope(mode), torch.no_grad():
        out = model(batch, train=True)
    assert out.dtype == torch.float32 and out.shape[:2] == batch.node_mask.shape
    err = float((_real_rows(out, coo) - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


@pytest.mark.parametrize("train", [True, False])
def test_padding_changes_no_real_row(drawn, train):
    ref, specs, w, coo = drawn
    model = _model(specs, w)
    graphs = [graph_from_arrays(f, s, d, y, rslot=True) for f, s, d, y in coo]
    small = batch_graphs(graphs)
    large = batch_graphs(graphs, n_pad=2 * small.num_nodes_padded,
                         d_pad=2 * small.max_degree)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with precision_scope("exact"), torch.no_grad():
        a = model(small, train=train)
        model.load_state_dict(state)
        b = model(large, train=train)
    assert torch.allclose(_real_rows(a, coo), _real_rows(b, coo), rtol=0, atol=1e-6)
    # padded rows come out of every BatchNorm as 0: the head's bias alone
    assert torch.equal(b[:, small.num_nodes_padded:],
                       model.post[-1].b_lin.expand_as(b[:, small.num_nodes_padded:]))


def test_masked_batch_norm_is_batch_norm_over_real_rows():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((3, 40, 8), generator=gen) * 3 + 1
    mask = (torch.rand((3, 40), generator=gen) < 0.6).float()
    bn = MaskedBatchNorm(8)
    with torch.no_grad():
        bn.g.uniform_(-0.5, 0.5, generator=gen)
        bn.b.uniform_(-0.1, 0.1, generator=gen)
    rm, rv = torch.zeros(8), torch.ones(8)
    rows = x[mask > 0]
    want = torch.nn.functional.batch_norm(rows, rm, rv, 1 + bn.g, bn.b,
                                          training=True, momentum=0.1, eps=1e-5)
    # with mask None the caller has zeroed the padded rows: the same
    # statistics, and the padded rows left as the shift
    pre = MaskedBatchNorm(8)
    pre.load_state_dict(bn.state_dict())
    got_pre = pre(x * mask[..., None], None, mask.sum(), train=True)
    got = bn(x, mask, mask.sum(), train=True)
    assert torch.allclose(got[mask > 0], want, atol=1e-6)
    assert torch.equal(got[mask == 0], torch.zeros_like(got[mask == 0]))
    assert torch.equal(got_pre[mask > 0], got[mask > 0])
    assert torch.equal(pre.running_var, bn.running_var)
    # running statistics as torch updates them (the unbiased variance)
    assert torch.allclose(bn.running_mean, rm, atol=1e-6)
    assert torch.allclose(bn.running_var, rv, atol=1e-6)
    want = torch.nn.functional.batch_norm(rows, rm, rv, 1 + bn.g, bn.b,
                                          training=False, eps=1e-5)
    got = bn(x, mask, mask.sum(), train=False)
    assert torch.allclose(got[mask > 0], want, atol=1e-6)


def test_padded_keys_get_no_weight():
    """Attention over a padded graph equals attention over its real nodes
    alone: the SDPA path's key-mask channel (float32) and the varlen
    kernels' plain version (which gives 0 on padded rows)."""
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn((2, 12, 3, 12), generator=gen) for _ in range(3))
    qkv = torch.cat([t.reshape(2, 12, 36) for t in (q, k, v)], -1)
    mask = torch.zeros(2, 12)
    mask[0, :7], mask[1, :12] = 1, 1
    n_real = mask.sum(1).to(torch.int32)
    sdpa = graph_attention(qkv, 3, mask, n_real).view(2, 12, 3, 12)
    plain = graph_attn.graph_attn_plain(qkv, n_real, 3)[0].view(2, 12, 3, 12)
    for b, n in ((0, 7), (1, 12)):
        s = torch.einsum("ihf,jhf->hij", q[b, :n], k[b, :n]) / math.sqrt(12)
        want = torch.einsum("hij,jhf->ihf", torch.softmax(s, -1), v[b, :n])
        assert torch.allclose(sdpa[b, :n], want, atol=1e-6)
        assert torch.allclose(plain[b, :n], want, atol=1e-6)
    assert torch.equal(plain[0, 7:], torch.zeros_like(plain[0, 7:]))


class _Graphs:
    """The trainer's data protocol over fixed graphs."""

    def __init__(self, graphs):
        self.graphs = graphs

    def __len__(self):
        return len(self.graphs)

    def get_graph(self, i):
        return self.graphs[i]


def test_three_adamw_steps_match_the_reference(drawn):
    """Losses, the first gradient (from AdamW's first moment, as the
    benchmark reads it) and the parameters after three steps of one epoch
    of 6 graphs in batches of 2, against reference/train.steps."""
    ref, specs, w, coo = drawn
    coo6 = coo + coo[::-1]
    hp = _hp(batch_size=2, lr=5e-3, w_decay=1e-2)
    trainer = GNNTrainer("GPS", hp, _Graphs([graph_from_arrays(f, s, d, y, rslot=True)
                                             for f, s, d, y in coo6]),
                         seed=3, precision="exact", device="cpu")
    params = trainer.model.jax_parameters()
    weights.load_into(params, w, specs)
    names = [name for name, _, _ in specs]
    losses, first = [], {}
    step = trainer._step

    def keep(batch, generator):
        loss = step(batch, generator)
        losses.append(float(loss))
        if len(losses) == 1:
            first.update({k: trainer.optimizer.state[p]["exp_avg"].double() / 0.1
                          for k, p in zip(names, params)})
        return loss

    trainer._step = keep
    trainer.run_epoch()
    order = np.random.default_rng((3, 0)).permutation(6)
    batches = [[coo6[i] for i in order[s:s + 2]] for s in (0, 2, 4)]
    train = {"class_weights": hp.class_weights, "w_decay": hp.w_decay}
    r_loss, r_grad, r_params = ref_train.steps(CFG, train, w, batches,
                                               [epoch_lr(hp.lr, hp.lr_decay, 0)] * 3,
                                               REFERENCE, "cpu")
    assert len(losses) == 3
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, r_loss)) < 1e-5
    assert ref_train.leaf_gap(first, r_grad) < 1e-4
    w0 = {k: v.double() for k, v in w.items()}
    moved = {k: p.detach().double() - w0[k] for k, p in zip(names, params)}
    want = {k: r_params[k] - w0[k] for k in names}
    assert ref_train.leaf_gap(moved, want, ref_train.moved_leaves(r_grad)) < 1e-3


def _trained(drawn, epochs=2, precision="exact"):
    ref, specs, w, coo = drawn
    graphs = [graph_from_arrays(f, s, d, y, rslot=True) for f, s, d, y in coo]
    trainer = GNNTrainer("GPS", _hp(batch_size=2), _Graphs(graphs), seed=1,
                         precision=precision, device="cpu")
    weights.load_into(trainer.model.jax_parameters(), w, specs)
    for _ in range(epochs):
        trainer.run_epoch()
    return trainer, graphs


def test_counters_count_the_steps_attention_pairs(drawn):
    """attn_pairs and attn_real_pairs of a "fast" epoch: two steps, the
    second a remainder batch whose masked copy holds no real node. The
    varlen forward visits the pairs of the 128 x 32 tiles that hold a real
    row (128 x 64 for the graphs of 50 and 64 nodes, 128 x 96 for the one of
    80) and none of the empty graph."""
    trainer, graphs = _trained(drawn, epochs=1, precision="fast")
    stats = trainer.last_epoch_stats
    per = 2 * 2                              # heads x layers
    assert stats["steps"] == 2
    assert stats["attn_pairs"] == per * (128 * 64 + 128 * 96 + 128 * 64)
    assert stats["attn_real_pairs"] == per * sum(n * n for n in SIZES)


def test_counters_count_padded_pairs_in_exact(drawn):
    """In "exact" the SDPA path computes every pair of the padded graphs,
    the masked copy's too."""
    trainer, graphs = _trained(drawn, epochs=1)
    stats = trainer.last_epoch_stats
    n_pad = trainer._shape_budget[0]
    per = 2 * 2
    assert stats["steps"] == 2
    assert stats["attn_pairs"] == per * 4 * n_pad ** 2
    assert stats["attn_real_pairs"] == per * sum(n * n for n in SIZES)


def test_spans_time_each_block(drawn):
    """gps.local, gps.attn and gps.ffn: totals always, and under a profiler
    their timeline entries, once per layer and step."""
    trainer, _ = _trained(drawn, epochs=1)
    assert set(trainer.model.host_s) == {"local", "attn", "ffn"}
    assert all(v > 0 for v in trainer.model.host_s.values())
    spans.timeline()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.run_epoch()
    names = [e[0] for e in spans.timeline()]
    for name in ("gps.local", "gps.attn", "gps.ffn"):
        assert names.count(name) == 2 * 2, name      # layers x steps


def test_hardcoded_hyperparameters_are_vocsp():
    hp = hardcoded_hyperparameters("GPS")
    assert (hp.layer_sizes, hp.gps_heads, hp.gps_post_layers) == ([96] * 4, 8, 3)
    assert (hp.lr, hp.w_decay) == (5e-4, 0.0)
    model = init_graph_net("GPS", hp)
    assert model.width == 96 and model.num_layers == 4
    # the configuration the benchmark runs is the same model
    cfg_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "benchmark", "configs", "gps-gatedgcn-4x96.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    assert ([n for n, _, _ in load_model("GPS").specs(cfg)] == model.leaf_names())


def _fake_mri(directory, shape=(32, 32, 24), seed=3):
    """Four modalities of a bright ellipsoid with a brighter sphere inside."""
    from gnn_tumor_seg_tpu_torch.data import nifti

    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    center = np.array(shape) / 2
    brain = np.linalg.norm((grid - center) / (np.array(shape) / 2.5), axis=-1) < 1
    tumor = (np.linalg.norm(grid - center, axis=-1) < 6) & brain
    for m, ext in enumerate(["_flair.nii.gz", "_t1.nii.gz", "_t1ce.nii.gz",
                             "_t2.nii.gz"]):
        vol = np.zeros(shape, np.int16)
        vol[brain] = 200 + 50 * m + rng.integers(0, 30, brain.sum())
        vol[tumor] += 150 + 40 * m
        nifti.write_nifti(vol, str(directory / f"case{ext}"))
    return shape


def test_predict_single_serves_a_gps_checkpoint(drawn, tmp_path):
    """The model type comes from the checkpoint; the running statistics
    with it."""
    from gnn_tumor_seg_tpu_torch.cli import predict_single
    from gnn_tumor_seg_tpu_torch.data import nifti
    from gnn_tumor_seg_tpu_torch.models.refine_cnn import CnnRefinementNet

    trainer, _ = _trained(drawn, epochs=1)
    trainer.save_weights(f"{tmp_path}/", "gps", include_opt_state=False)
    cnn_hp = HyperParams(in_feats=8, layer_sizes=[8])
    checkpoint.save_checkpoint(f"{tmp_path}/cnn.ckpt",
                               CnnRefinementNet(8, 4, [8], torch.Generator().manual_seed(8)),
                               "CNN", cnn_hp)
    shape = _fake_mri(tmp_path / "raw" / "case")
    predict_single.main(["-i", str(tmp_path / "raw" / "case"), "-o", str(tmp_path / "out"),
                         "-g", f"{tmp_path}/gps.ckpt", "-c", f"{tmp_path}/cnn.ckpt",
                         "-n", "200", "-k", "6", "--slic_impl", "native",
                         "--device", "cpu"])
    out = list((tmp_path / "out").iterdir())
    assert [p.name for p in out] == ["case.nii.gz"]
    pred = nifti.read_nifti(str(out[0]), np.int16)
    assert pred.shape == shape and set(np.unique(pred)) <= {0, 1, 2, 4}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A tiny preprocessed data directory (the port's store and NIfTI
    writer), as cli.train_gnn reads it."""
    from gnn_tumor_seg_tpu_torch.data import nifti, store
    from gnn_tumor_seg_tpu_torch.data.graph_build import GraphSample
    from gnn_tumor_seg_tpu_torch.data.synthetic import make_synthetic_sample

    root = tmp_path_factory.mktemp("processed")
    rng = np.random.default_rng(0)
    for i in range(4):
        feats, src, dst, labels, sv, voxlab = make_synthetic_sample(rng, grid=4)
        d = root / f"brain_{i}"
        d.mkdir()
        store.save_graph_npz(str(d / f"brain_{i}_graph.npz"), GraphSample(
            feats=feats, labels=labels, centroids=np.zeros((len(feats), 3)),
            src=src, dst=dst, sv_partition=None))
        nifti.save_as_nifti(sv, str(d / f"brain_{i}_supervoxels.nii.gz"))
        nifti.save_as_nifti(voxlab, str(d / f"brain_{i}_label.nii.gz"))
    return str(root)


GPS_FLAGS = ["-m", "GPS", "-k", "1", "--hp", "n_epochs=2", "--hp", "layer_sizes=[8, 8]",
             "--hp", "gps_heads=2", "--hp", "batch_size=2", "--device", "cpu"]


def test_train_gnn_cli_trains_gps(data_dir, tmp_path):
    from gnn_tumor_seg_tpu_torch.cli import train_gnn

    out = str(tmp_path)
    train_gnn.main(["-d", data_dir, "-o", out, "-r", "gps", *GPS_FLAGS])
    ckpt = [f for f in os.listdir(out) if f.endswith(".ckpt")]
    assert len(ckpt) == 1
    leaves, model_type, hp, manifest = checkpoint.load_checkpoint(os.path.join(out, ckpt[0]))
    assert model_type == "GPS" and hp.layer_sizes == [8, 8] and hp.gps_post_layers == 3
    assert manifest["n_buffers"] > 0 and manifest["extra"]["epoch"] == 2
    with open(os.path.join(out, "gps.txt")) as f:
        text = f.read()
    assert "Model\tGPS" in text and "Heads\t2" in text


@pytest.mark.parametrize("regime", ["dp", "halo"])
def test_gps_refuses_distribution(data_dir, tmp_path, regime):
    """Batch statistics over ranks, or attention over a partitioned graph,
    the port does not have: GPS trains on one device."""
    from gnn_tumor_seg_tpu_torch.cli import train_gnn

    with pytest.raises(NotImplementedError, match="one device"):
        train_gnn.main(["-d", data_dir, "-o", str(tmp_path), "-r", "x",
                        "--parallel", regime, *GPS_FLAGS])


def test_dropout_acts_only_in_training(drawn):
    """feature_dropout reaches GraphGPS's dropout sites: in training the
    generator's draws change the logits (the same draws, the same logits);
    in evaluation it does nothing."""
    ref, specs, w, coo = drawn
    model = init_graph_net("GPS", _hp(feature_dropout=0.3))
    weights.load_into(model.jax_parameters(), w, specs)
    batch = batch_graphs([graph_from_arrays(f, s, d, y, rslot=True) for f, s, d, y in coo])
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def run(train, seed):
        model.load_state_dict(state)
        with precision_scope("exact"), torch.no_grad():
            return model(batch, train=train, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(True, 1), run(True, 1))
    assert not torch.equal(run(True, 1), run(True, 2))
    assert torch.equal(run(False, 1), run(False, 2))
    plain = _model(specs, w)
    with precision_scope("exact"), torch.no_grad():
        assert torch.equal(run(False, 1), plain(batch))
