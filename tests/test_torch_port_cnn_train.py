"""CNNTrainer: the port's refinement-CNN engine against the JAX package's.

Tiny in-process images (the pattern of tests/test_misc.py): four samples of
12x10x8 voxels with 4 channels, numpy-seeded, logit files written for three
of them (the fourth is skipped, as `model/cnn_model.py:40-43` skips it).
GTS_CNN_CROP_FLOOR=none (tests/conftest.py), so crops are 16-bucketed. Both
trainers run in "exact" from the same parameters (the JAX trainer's,
carried across with load_params) and shuffle with one seed, so they visit
the samples in the same order.

Tolerances, each from float32 convolutions of 125 x C taps summed in
another order (XLA against PyTorch's CPU kernels): epoch losses within
1e-5 relative; parameters after 3 epochs within rtol 1e-4, atol 1e-6 (AdamW
divides by the root of the second moment, which magnifies relative
differences where a gradient is near 0, hence the absolute term); the
evaluate metric vector within rtol 1e-5 (the loss; the Dice and HD95
entries agree exactly as the argmax agrees). A checkpoint restores
bitwise in either package, and one more epoch from it agrees to the same
tolerances. The prep cache is bitwise neutral, counts its hits and serves
`evaluate`.
"""

import jax
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.config import HyperParams as JaxHyperParams
from gnn_tumor_seg_tpu.data import nifti as jax_nifti
from gnn_tumor_seg_tpu.data.dataset import PredLogitDataset as JaxLogits
from gnn_tumor_seg_tpu.train.checkpoint import load_opt_state as jax_load_opt
from gnn_tumor_seg_tpu.train.cnn_trainer import CNNTrainer as JaxTrainer
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.convert import cnn_params_to_jax
from gnn_tumor_seg_tpu_torch.data import nifti
from gnn_tumor_seg_tpu_torch.data.dataset import PredLogitDataset
from gnn_tumor_seg_tpu_torch.train import cnn_trainer
from gnn_tumor_seg_tpu_torch.train.cnn_trainer import CNNTrainer
from gnn_tumor_seg_tpu_torch.train.optim import opt_state_leaves

SHAPE = (12, 10, 8)
IDS = ("a", "b", "c", "d")
HP = dict(n_epochs=3, in_feats=8, layer_sizes=[4], lr=1e-3,
          class_weights=[0.1, 5, 15, 15], batch_size=1)
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6


class _TinyImages:
    """Image-dataset stub: four samples; logit files under `root` for all
    but the last (blob positions differ by sample and by `shift`)."""

    def __init__(self, root, shift=0):
        self.ids = list(IDS)
        rng = np.random.default_rng(0)
        self._img = {i: rng.normal(size=SHAPE + (4,)).astype(np.float32)
                     for i in self.ids}
        self._lab = {i: rng.integers(0, 4, SHAPE).astype(np.int16)
                     for i in self.ids}
        for k, mri_id in enumerate(self.ids[:-1]):
            logits = rng.normal(scale=0.3, size=SHAPE + (4,)).astype(np.float32)
            o = k + shift
            logits[2 + o:7 + o, 3:7, 2:6, 1 + k] += 5.0    # predicted tumor
            nifti.save_as_nifti(logits, str(root / f"{mri_id}_logits.nii.gz"))

    def get_image(self, i):
        return self._img[i]

    def get_voxel_labels(self, i):
        return self._lab[i]


def _port_trainer(imgs, root, **kw):
    kw.setdefault("precision", "exact")
    return CNNTrainer(HyperParams(**HP), imgs, PredLogitDataset(str(root)),
                      seed=0, device="cpu", **kw)


def _jax_trainer(imgs, root):
    return JaxTrainer(JaxHyperParams(**HP), imgs, JaxLogits(str(root)), seed=0,
                      precision="exact")


def _jax_params(jt):
    return jax.tree_util.tree_map(np.asarray, jt.state.params)


def _assert_params_close(t, jt):
    got, want = cnn_params_to_jax(t.net), _jax_params(jt)
    for layer in ("conv0", "conv1"):
        for key in ("w", "b"):
            np.testing.assert_allclose(got[layer][key], want[layer][key],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    monkeypatch.setenv("GTS_PALLAS_PRECISION", "exact")
    return _TinyImages(tmp_path), tmp_path


def test_logit_dataset_matches_jax(tiny):
    imgs, root = tiny
    port, jax_ds = PredLogitDataset(str(root)), JaxLogits(str(root))
    for mri_id in IDS[:-1]:
        logits, crop = port.get_one(mri_id)
        want, want_crop = jax_ds.get_one(mri_id)
        assert logits.dtype == np.float32 and np.array_equal(logits, want)
        assert all(np.array_equal(a, b) for a, b in zip(crop, want_crop))
        assert port.get_crop(mri_id) is crop
    with pytest.raises(FileNotFoundError):
        port.get_one(IDS[-1])


def test_logit_nifti_round_trips_like_jax(tmp_path):
    """4-D float32 logit volumes [X, Y, Z, 4]: written by either package,
    read back bitwise by both."""
    vol = np.random.default_rng(1).normal(size=SHAPE + (4,)).astype(np.float32)
    nifti.write_nifti(vol, str(tmp_path / "port.nii.gz"))
    jax_nifti.write_nifti(vol, str(tmp_path / "jax.nii.gz"))
    for name in ("port", "jax"):
        fp = str(tmp_path / f"{name}.nii.gz")
        assert np.array_equal(nifti.read_nifti(fp, np.float32), vol)
        assert np.array_equal(jax_nifti.read_nifti(fp, np.float32), vol)


def test_three_epochs_and_evaluate_match_jax(tiny):
    imgs, root = tiny
    jt = _jax_trainer(imgs, root)
    t = _port_trainer(imgs, root)
    t.load_params(_jax_params(jt))
    for _ in range(HP["n_epochs"]):
        want = jt.run_epoch()
        got = t.run_epoch()
        assert got == pytest.approx(want, rel=LOSS_RTOL)
        assert t.last_epoch_stats["steps"] == len(IDS) - 1   # 'd' skipped
    assert t.epoch == int(jt.state.epoch) == HP["n_epochs"]
    _assert_params_close(t, jt)
    got, want = t.evaluate(), jt.evaluate()
    assert got.shape == want.shape == (7,)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert t.last_eval_stats["brains"] == len(IDS) - 1


def test_prep_cache_counts_hits_and_serves_evaluate(tiny, monkeypatch):
    """The cache is bitwise neutral (losses and metrics as with it off), is
    hit by every sample from epoch 2 on and by evaluate, and never holds the
    sample whose logits are missing."""
    imgs, root = tiny

    def run(cache_mb):
        monkeypatch.setenv("GTS_CNN_PREP_CACHE_MB", cache_mb)
        t = _port_trainer(imgs, root)
        losses, hits = [], []
        for _ in range(3):
            losses.append(t.run_epoch())
            hits.append(t.last_epoch_stats["prep_cache_hits"])
        return t, losses, hits, t.evaluate()

    t_off, off, off_hits, off_metrics = run("0")
    t_on, on, on_hits, on_metrics = run("64")
    assert t_off._prep_cache is None and off_hits == [0, 0, 0]
    n = len(IDS) - 1
    assert on_hits == [0, n, n]
    assert t_on.last_eval_stats["prep_cache_hits"] == n
    assert t_on.prep_cache_hits == 3 * n and len(t_on._prep_cache) == n
    assert off == on
    assert np.array_equal(off_metrics, on_metrics)


def test_second_logit_root_gets_no_stale_entry(tiny, tmp_path_factory):
    imgs, root = tiny
    root_b = tmp_path_factory.mktemp("logits_b")
    _TinyImages(root_b, shift=1)               # same images, moved blobs
    t = _port_trainer(imgs, root)
    t.run_epoch()
    t.logit_dataset = PredLogitDataset(str(root_b))
    t.run_epoch()
    assert t.last_epoch_stats["prep_cache_hits"] == 0
    logits, crop = PredLogitDataset(str(root_b)).get_one("a")
    before = t.prep_cache_hits
    prep = t._load_and_prepare("a")             # root B's entry, a hit
    assert t.prep_cache_hits == before + 1
    nx, ny, nz = prep.crop_shape
    assert np.array_equal(prep.x[0, :nx, :ny, :nz, 4:].numpy(), logits[crop])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_restores_both_ways(tiny, writer):
    """Two epochs by `writer`, saved with the optimizer state; a fresh
    trainer of each package restores the file (parameters, moments and
    epoch bitwise equal), and one more epoch from it agrees."""
    imgs, root = tiny
    jt = _jax_trainer(imgs, root)
    t = _port_trainer(imgs, root)
    t.load_params(_jax_params(jt))
    trainer = t if writer == "port" else jt
    for _ in range(2):
        trainer.run_epoch()
    trainer.save_weights(str(root) + "/", "ckpt")
    path = str(root / "ckpt.ckpt")
    jr, tr = _jax_trainer(imgs, root), _port_trainer(imgs, root)
    jr.restore(path)
    tr.restore(path)
    assert tr.epoch == int(jr.state.epoch) == 2
    got, want = cnn_params_to_jax(tr.net), _jax_params(jr)
    for layer in ("conv0", "conv1"):
        for key in ("w", "b"):
            assert np.array_equal(got[layer][key], want[layer][key])
    # the port's moments, written in the JAX layout, equal the restored leaves
    saved = cnn_trainer._permute_weight_moments(opt_state_leaves(tr.optimizer),
                                                cnn_trainer._OIDHW_TO_DHWIO)
    flat = jax.tree_util.tree_leaves(jr.state.opt_state)
    on_disk = jax_load_opt(path, jr.state.opt_state)
    assert len(saved) == len(flat)
    for a, b in zip(saved[8:], jax.tree_util.tree_leaves(on_disk)[8:]):
        assert np.array_equal(a, np.asarray(b))
    want = jr.run_epoch()
    got = tr.run_epoch()
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    _assert_params_close(tr, jr)


def test_fast_returns_f32_logits_from_bf16_convolutions(tiny, monkeypatch):
    imgs, root = tiny
    seen = []
    conv3d = torch.nn.functional.conv3d

    def spy(x, w, b=None, *args, **kw):
        seen.append((x.dtype, w.dtype))
        return conv3d(x, w, b, *args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv3d", spy)
    t = _port_trainer(imgs, root, precision="fast")
    loss = t.run_epoch()
    assert np.isfinite(loss) and t.last_epoch_stats["precision"] == "fast"
    prep = t._load_and_prepare("a")
    seen.clear()
    logits = t.predict_crop(prep.x)
    assert logits.dtype == np.float32 and logits.shape == prep.x.shape[:4] + (4,)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2
    assert np.isfinite(logits).all()


def test_trainer_refuses_a_missing_gpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    imgs, root = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CNNTrainer(HyperParams(**HP), imgs, PredLogitDataset(str(root)))
