"""GNNTrainer: the port's training engine against the JAX package's.

Both trainers start from the same parameters (the JAX trainer's, carried
across), on the same SyntheticGraphDataset (7 samples of grid 5, one seed:
both packages draw the same graphs), with batch size 3, so the last batch of
each epoch is padded with masked copies. Both run in "exact" mode with
dropout 0, the JAX side with impl="dense". Tolerances: per-epoch mean
losses within 1e-5, final parameters within 1e-4 (two epochs of float32
AdamW on gradients summed in another order), and the evaluate metric
vector equal (rtol 1e-5 for the loss entry, float32 sums; the Dice and HD95
entries and the label counts exactly, since the argmax agrees).

Checkpoints: a run resumed from a checkpoint continues bit for bit, and a
checkpoint with optimizer state written by either package resumes in the
other with equal leaves.
"""

import jax
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.config import HyperParams as JaxHyperParams
from gnn_tumor_seg_tpu.data.synthetic import SyntheticGraphDataset as JaxSynthetic
from gnn_tumor_seg_tpu.ops.pallas.precision import precision_scope as jax_precision
from gnn_tumor_seg_tpu.train.checkpoint import load_checkpoint as jax_load
from gnn_tumor_seg_tpu.train.checkpoint import load_opt_state as jax_load_opt
from gnn_tumor_seg_tpu.train.gnn_trainer import GNNTrainer as JaxTrainer
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.data.synthetic import SyntheticGraphDataset
from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer
from gnn_tumor_seg_tpu_torch.train.optim import opt_state_leaves

HP = dict(n_epochs=2, layer_sizes=[32, 32], lr=3e-3, batch_size=3)


def _pair(model_type, n_samples=7, seed=3):
    jdata = JaxSynthetic(n_samples=n_samples, grid=5, seed=seed)
    data = SyntheticGraphDataset(n_samples=n_samples, grid=5, seed=seed)
    jt = JaxTrainer(model_type, JaxHyperParams(**HP), jdata, seed=0,
                    impl="dense", precision="exact")
    t = GNNTrainer(model_type, HyperParams(**HP), data, seed=0,
                   precision="exact", device="cpu")
    t.load_params(jax.tree_util.tree_map(np.asarray, jt.state.params))
    return jt, jdata, t, data


def _leaves(trainer):
    return [p.detach().numpy().copy() for p in trainer.model.jax_parameters()]


@pytest.mark.parametrize("model_type", ["GSpool", "GSmean"])
def test_two_epochs_and_evaluate_match_jax(model_type):
    jt, jdata, t, data = _pair(model_type)
    for _ in range(2):
        want, got = jt.run_epoch(), t.run_epoch()
        assert abs(got - want) <= 1e-5, (got, want)
    assert t.last_epoch_stats["steps"] == 3 and t.epoch == 2
    assert t.last_epoch_stats["impl"] == "plain"
    for got, want in zip(_leaves(t), jax.tree_util.tree_leaves(jt.state.params)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)

    with jax_precision("exact"):
        m_j, c_j = jt.evaluate(jdata, batch_size=3, workers=2)
    m_t, c_t = t.evaluate(data, batch_size=3, workers=2)
    assert t.last_eval_stats["batches"] == 3 and t.last_eval_stats["brains"] == 7
    np.testing.assert_allclose(m_t[0], m_j[0], rtol=1e-5)
    np.testing.assert_array_equal(m_t[1:], m_j[1:])
    np.testing.assert_array_equal(c_t, c_j)
    logits = t.predict_nodes(data.get_graph(0))
    assert logits.shape == (int(data.get_graph(0).n_nodes[0]), 4)


def test_resume_continues_bit_for_bit(tmp_path):
    data = SyntheticGraphDataset(n_samples=5, grid=4, seed=6)
    hp = HyperParams(**{**HP, "feature_dropout": 0.2})    # dropout resumes too
    straight = GNNTrainer("GSpool", hp, data, seed=0, device="cpu")
    assert straight.precision == "fast"                    # the training default
    for _ in range(2):
        straight.run_epoch()

    first = GNNTrainer("GSpool", hp, data, seed=0, device="cpu")
    first.run_epoch()
    first.save_weights(str(tmp_path) + "/", "mid")
    resumed = GNNTrainer.from_checkpoint(str(tmp_path / "mid.ckpt"), data, seed=0,
                                         device="cpu")
    assert resumed.epoch == 1
    resumed.run_epoch()
    for a, b in zip(_leaves(straight), _leaves(resumed)):
        assert np.array_equal(a, b)
    for a, b in zip(opt_state_leaves(straight.optimizer),
                    opt_state_leaves(resumed.optimizer)):
        assert np.array_equal(a, b)


def test_optimizer_checkpoints_cross_both_ways(tmp_path):
    jt, jdata, t, data = _pair("GSpool", n_samples=3, seed=4)
    jt.run_epoch()
    t.run_epoch()

    # port -> JAX
    t.save_weights(str(tmp_path) + "/", "port")
    params, model_type, _, manifest = jax_load(str(tmp_path / "port.ckpt"),
                                               jt.state.params)
    opt = jax_load_opt(str(tmp_path / "port.ckpt"), jt.state.opt_state)
    assert model_type == "GSpool" and manifest["extra"]["epoch"] == 1
    assert manifest["n_opt"] == len(jax.tree_util.tree_leaves(jt.state.opt_state))
    for a, b in zip(jax.tree_util.tree_leaves(params), _leaves(t)):
        assert np.array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree_util.tree_leaves(opt), opt_state_leaves(t.optimizer)):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)

    # JAX -> port: the resumed trainer holds the JAX state exactly
    jt.save_weights(str(tmp_path) + "/", "jax")
    resumed = GNNTrainer.from_checkpoint(str(tmp_path / "jax.ckpt"), data,
                                         device="cpu")
    assert resumed.epoch == 1 and resumed.model_type == "GSpool"
    for a, b in zip(jax.tree_util.tree_leaves(jt.state.params), _leaves(resumed)):
        assert np.array_equal(np.asarray(a), b)
    want = jax.tree_util.tree_leaves(jt.state.opt_state)
    got = opt_state_leaves(resumed.optimizer)
    for i, (a, b) in enumerate(zip(want, got)):
        if i == 5:      # learning rate: set from the epoch when a run starts
            continue
        assert np.array_equal(np.asarray(a), b), i
    with pytest.raises(ValueError, match="GSmean"):
        GNNTrainer("GSmean", HyperParams(**HP), data, device="cpu").restore(
            str(tmp_path / "jax.ckpt"))
    assert torch.equal(resumed.class_weights, torch.tensor([0.1, 1, 2, 2]))


def test_epoch_host_phases_and_device_cache_counters(monkeypatch):
    """last_epoch_stats: the host's seconds by phase of the step cover the
    epoch, and the device cache's misses and upload bytes count the first
    epoch's copies; with no profiler no step opens a record_function."""
    from gnn_tumor_seg_tpu_torch import spans
    from gnn_tumor_seg_tpu_torch.data.cache import nbytes_of
    from gnn_tumor_seg_tpu_torch.train.gnn_trainer import HOST_PHASES

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    data = SyntheticGraphDataset(n_samples=7, grid=5, seed=3)
    t = GNNTrainer("GSpool", HyperParams(**HP), data, seed=0, device="cpu")
    for epoch in range(2):
        t.run_epoch()
        s = t.last_epoch_stats
        assert set(s["host_s"]) == set(HOST_PHASES)
        assert all(v > 0 for v in s["host_s"].values())
        assert 0.8 * s["seconds"] <= sum(s["host_s"].values()) <= 1.005 * s["seconds"]
        assert s["cache_misses"] == (len(data) if epoch == 0 else 0)
        want = sum(nbytes_of(data.get_graph(i)) for i in range(len(data)))
        assert s["upload_bytes"] == (want if epoch == 0 else 0)
        assert s["profiled"] is False and spans.recent("train.epoch")[-1] is s


def test_step_spans_in_a_profile():
    """Under torch.profiler each step is one gnn_train_step holding its
    four phase spans, and the timeline's spans of the epoch share its unit."""
    from torch.profiler import ProfilerActivity, profile

    from gnn_tumor_seg_tpu_torch import spans

    data = SyntheticGraphDataset(n_samples=7, grid=5, seed=3)
    t = GNNTrainer("GSpool", HyperParams(**HP), data, seed=0, device="cpu")
    t.run_epoch()
    spans.timeline()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.run_epoch()
    entries = spans.timeline()
    steps = t.last_epoch_stats["steps"]
    names = [e[0] for e in entries]
    assert t.last_epoch_stats["profiled"] is True
    for name, n in [("gnn_train_step", steps), ("train.batch", steps),
                    ("train.forward", steps), ("train.backward", steps),
                    ("train.optim", 2 * steps), ("train.epoch_sync", 1),
                    ("train.epoch", 1)]:
        assert names.count(name) == n, name
        assert sum(ev.name == name for ev in prof.events()) == n, name
    parents = {e[0]: e[3] for e in entries}
    assert parents["train.forward"] == parents["train.optim"] == "gnn_train_step"
    assert parents["train.batch"] == parents["gnn_train_step"] == "train.epoch"
    assert len({e[4] for e in entries}) == 1
