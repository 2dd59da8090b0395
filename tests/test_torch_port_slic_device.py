"""The device preprocessing chain (gnn_tumor_seg_tpu_torch/ops/slic_device.py)
against the JAX package's (gnn_tumor_seg_tpu/ops/slic_tpu.py), on the CPU.

The same numpy-seeded volumes (36x28x24, 40x37x29 and 30x26x22, those of
tests/test_slic_tpu.py) go through the JAX functions, run on the CPU as the
JAX package's tests run them, and through the port with device="cpu".

Tolerances:
  * q and the standardized volume: bitwise equal to the JAX chain's (and to
    the port's host normalize -> standardize);
  * smoothing: within 2e-5 of the JAX package's and of scipy's;
  * raw SLIC labels: >= 0.995 of the voxels agree with the JAX device SLIC
    and >= 0.98 with the port's host canonical (majority-label agreement,
    `_agreement`: label ids may renumber when a boundary voxel flips); two
    runs bitwise equal; on a piecewise-constant integer volume (exact ties,
    exact center sums in both packages) bitwise the JAX device SLIC's;
  * serving (the 32x32x24 case of tests/test_torch_port_serve.py): >= 0.999
    of the final labels agree with the port's host-prep path in "exact"
    (>= 0.9 in "fast") and with the JAX device path in "exact"; with the
    JAX chain's outputs in place of the port's, the labels equal the JAX
    device path's up to the CNN's near-ties (MARGIN_TOL);
  * bulk preprocessing: the standardized input volume bitwise equal to the
    host path's and the JAX device path's; partition, edges and labels
    identical to the port's host path with --slic_impl tpu; features within
    2e-5 (the affine-commuted quantiles).
"""


import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from scipy import ndimage

from gnn_tumor_seg_tpu.cli import common as jax_common
from gnn_tumor_seg_tpu.cli.common import (load_cnn_from_checkpoint as jax_load_cnn,
                                          load_gnn_from_checkpoint as jax_load_gnn)
from gnn_tumor_seg_tpu.cli.predict_single import predict_single_mri as jax_predict
from gnn_tumor_seg_tpu.data import image as jax_image
from gnn_tumor_seg_tpu.data import nifti as jax_nifti
from gnn_tumor_seg_tpu.data.preprocess import DataPreprocessor as JaxPreprocessor
from gnn_tumor_seg_tpu.ops import slic_tpu
from gnn_tumor_seg_tpu.ops.pallas.precision import precision_scope as jax_precision
from gnn_tumor_seg_tpu_torch import runtime
from gnn_tumor_seg_tpu_torch.cli import predict_single as port_cli
from gnn_tumor_seg_tpu_torch.cli import warmup
from gnn_tumor_seg_tpu_torch.cli.common import (load_cnn_from_checkpoint,
                                                load_gnn_from_checkpoint,
                                                resolve_slic_fn)
from gnn_tumor_seg_tpu_torch.data import nifti, store
from gnn_tumor_seg_tpu_torch.data.image import (_fast_quantile_per_channel,
                                                normalize_img, standardize_img)
from gnn_tumor_seg_tpu_torch.data.preprocess import DataPreprocessor
from gnn_tumor_seg_tpu_torch.data.slic import _cell_of, _init_grid, slic_supervoxels
from gnn_tumor_seg_tpu_torch.ops import slic_device
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from tests.test_pipeline_e2e import make_fake_brats_dir
from tests.test_slic_tpu import _agreement, _volume
from tests.test_torch_port_serve import K, MARGIN_TOL, NUM_NODES, case  # noqa: F401

MEAN = np.array([0.4, 0.5, 0.45, 0.4], np.float32)
STD = np.array([0.15, 0.17, 0.12, 0.16], np.float32)
VOLUMES = [((36, 28, 24), 0), ((40, 37, 29), 3), ((30, 26, 22), 1)]


def _raw(kind):
    """Raw 4-channel volumes of test_slic_tpu's serve tests, and an
    integral one that takes the int16 wire."""
    rng = np.random.default_rng(4)
    if kind == "negative":
        return (rng.random((30, 26, 22, 4)).astype(np.float32) - 0.3) * 50.0
    if kind == "integral":
        return rng.integers(-900, 4000, (30, 26, 22, 4)).astype(np.float32)
    raw = np.random.default_rng(3).random((40, 37, 29, 4)).astype(np.float32) * 97.0
    raw[:5] = 0.0
    return raw


# ------------------------------------------------------------------ the chain


@pytest.mark.parametrize("kind,fast", [("positive", False), ("negative", False),
                                       ("integral", False), ("negative", True),
                                       ("integral", True)],
                         ids=["positive", "negative", "integral-int16-wire",
                              "fast-bf16-wire", "fast-int16-wire"])
def test_quantile_matches_jax(kind, fast):
    """q bitwise equal to the JAX chain's, in every wire: float32; bfloat16
    under "fast" (the quantile of the rounded values); int16 for integral
    data, exact also under "fast"."""
    raw = _raw(kind)
    _, _, qj, _ = slic_tpu.serve_preprocess_tpu(
        raw, 27, 0.5, MEAN, STD, sigma=0.0,
        input_dtype=ml_dtypes.bfloat16 if fast else np.float32)
    _, vol, q, _ = slic_device.serve_preprocess_device(
        raw, 27, 0.5, MEAN, STD, sigma=0.0,
        input_dtype=torch.bfloat16 if fast else torch.float32, device="cpu")
    assert q.dtype == np.float32 and np.array_equal(q, qj)
    seen = raw
    if fast and kind != "integral":
        seen = raw.astype(ml_dtypes.bfloat16).astype(np.float32)
        assert not np.array_equal(q, _fast_quantile_per_channel(raw, 0.995))
    assert np.array_equal(q, _fast_quantile_per_channel(seen, 0.995))
    assert vol.device.type == "cpu" and vol.dtype == torch.float32


def test_standardized_volume_matches_jax():
    """The standardized volume bitwise equal to JAX's dev_std (its (X, Z, Y)
    frame transposed back) and to the host normalize -> standardize; the
    chain's labels bitwise equal to slic_assign_device on the host-
    standardized volume with the smoothing on the device, and at least
    0.995 equal to the JAX chain's."""
    raw = _raw("positive")
    X, Y, Z, _ = raw.shape
    lj, dev_std, _, step_j = slic_tpu.serve_preprocess_tpu(
        raw, 64, 0.5, MEAN, STD, sigma=1.0)
    labels, vol, q, step = slic_device.serve_preprocess_device(
        raw, 64, 0.5, MEAN, STD, sigma=1.0, device="cpu")
    got = vol.permute(1, 2, 3, 0).numpy()
    assert np.array_equal(got, np.asarray(dev_std).transpose(1, 3, 2, 0))
    host_std = standardize_img(normalize_img(raw), MEAN, STD)
    assert np.array_equal(got, host_std)
    assert step == step_j and labels.dtype == np.int32
    assert np.array_equal(labels, slic_device.slic_assign_device(
        host_std, 64, 0.5, smooth_sigma=1.0, device="cpu"))
    assert (labels == lj).mean() >= 0.995


@pytest.mark.parametrize("shape", [(20, 17, 14), (5, 9, 6)],
                         ids=["20x17x14", "extent-just-above-radius"])
def test_gauss_smooth_matches_jax_and_scipy(shape):
    rng = np.random.default_rng(11)
    X, Y, Z = shape
    vol = rng.normal(size=(3, X, Y, Z)).astype(np.float32)
    want = np.stack([ndimage.gaussian_filter(v, 1.0, mode="reflect") for v in vol])
    w = slic_tpu._gauss_kernel1d(1.0)
    assert np.array_equal(slic_device.gauss_kernel1d(1.0), w)
    jax_t = slic_tpu._gauss_smooth_t(
        jnp.asarray(vol.transpose(0, 1, 3, 2)), jnp.int32(X), jnp.int32(Z),
        jnp.int32(Y), jnp.asarray(w), taps=len(w))
    got = slic_device.gauss_smooth(torch.from_numpy(vol), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jax_t).transpose(0, 1, 3, 2),
                               rtol=2e-5, atol=2e-5)


def test_smooth_extent_guard():
    with pytest.raises(ValueError, match="too small"):
        slic_device.serve_preprocess_device(np.ones((3, 20, 20, 1), np.float32),
                                            8, 0.5, [0.0], [1.0], device="cpu")
    with pytest.raises(ValueError, match="too small"):
        slic_device.slic_assign_device(np.ones((20, 4, 20, 1), np.float32), 8,
                                       0.5, smooth_sigma=1.0, device="cpu")


@pytest.mark.parametrize("shape,seed", VOLUMES,
                         ids=["x".join(map(str, s)) for s, _ in VOLUMES])
def test_raw_assignment_matches_jax(shape, seed):
    """Raw labels: >= 0.995 agreement with slic_assign_tpu (pad_shape=None)
    on the same smoothed input, >= 0.98 with the host canonical; int32 in
    numpy cell numbering; two runs bitwise equal."""
    vol = _volume(shape, seed=seed)
    sm = np.stack([ndimage.gaussian_filter(vol[..., c], 1.0)
                   for c in range(vol.shape[-1])], -1)
    want = slic_tpu.slic_assign_tpu(sm, 48, 0.5, pad_shape=None)
    got = slic_device.slic_assign_device(sm, 48, 0.5, device="cpu")
    assert got.dtype == np.int32 and got.shape == shape
    assert _agreement(got, want) >= 0.995
    host = slic_supervoxels(vol, n_segments=48, compactness=0.5,
                            use_native=False, enforce_connectivity=False)
    assert _agreement(host, got) >= 0.98
    assert np.array_equal(got, slic_device.slic_assign_device(sm, 48, 0.5,
                                                              device="cpu"))
    # no iteration: every voxel keeps its own cell, (cx*gy + cy)*gz + cz
    (gx, gy, gz), _ = _init_grid(shape, 48)
    cx, cy, cz = (_cell_of(np.arange(s), s, g) for s, g in zip(shape, (gx, gy, gz)))
    own = (cx[:, None, None] * gy + cy[None, :, None]) * gz + cz[None, None, :]
    assert np.array_equal(slic_device.slic_assign_device(
        sm, 48, 0.5, max_iter=0, device="cpu"), own)


def _blocks(seed, shape=(30, 26, 22, 4), n_blocks=6):
    """A piecewise-constant, integer-valued volume: n_blocks boxes of values
    1-3 on 0. Distances tie exactly wherever the volume is constant, and
    both packages' center sums are exact on it."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    for _ in range(n_blocks):
        lo = [int(rng.integers(0, s - 4)) for s in shape[:3]]
        hi = [int(rng.integers(l + 3, s + 1)) for l, s in zip(lo, shape[:3])]
        vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = rng.integers(
            1, 4, shape[3]).astype(np.float32)
    return vol


@pytest.mark.parametrize("seed,max_iter", [(0, 1), (3, 3), (2, 10)])
def test_raw_assignment_ties_match_jax(seed, max_iter):
    """On exact ties the first candidate visited wins: the port visits the
    27 candidates in the JAX package's order, so its raw labels on a
    piecewise-constant volume are bitwise slic_assign_tpu's (in the port's
    former (dx, dy, dz) order, 4, 29 and 58 of these 17 160 labels
    differ)."""
    vol = _blocks(seed)
    want = slic_tpu.slic_assign_tpu(vol, 200, 0.5, max_iter=max_iter,
                                    pad_shape=None)
    got = slic_device.slic_assign_device(vol, 200, 0.5, max_iter=max_iter,
                                         device="cpu")
    assert np.array_equal(got, np.asarray(want))


def test_slic_supervoxels_device_is_a_slic_fn():
    """The --slic_impl tpu route: contiguous final labels that agree with
    the host canonical; under "fast" it rounds the volume to bfloat16."""
    vol = _volume(seed=7, shape=(20, 18, 16))
    fn = resolve_slic_fn("tpu", device="cpu")
    lab = fn(vol, n_segments=27, compactness=0.5)
    assert lab.shape == vol.shape[:3]
    assert np.array_equal(np.unique(lab), np.arange(lab.max() + 1))
    host = resolve_slic_fn("numpy")(vol, n_segments=27, compactness=0.5)
    assert _agreement(host, lab) >= 0.98
    with precision_scope("fast"):
        fast = fn(vol, n_segments=27, compactness=0.5)
    rounded = vol.astype(ml_dtypes.bfloat16).astype(np.float32)
    assert np.array_equal(fast, fn(rounded, n_segments=27, compactness=0.5))


def test_entry_points_refuse_a_missing_gpu(tmp_path):
    """Left at their default device, the chain's entry points raise without
    a card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    raw = _raw("integral")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slic_device.serve_preprocess_device(raw, 27, 0.5, MEAN, STD)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slic_device.slic_assign_device(raw, 27, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_slic_fn("tpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataPreprocessor(str(tmp_path), str(tmp_path / "out"), prep_impl="device")
    assert runtime.resolve_device("cpu").type == "cpu"


# -------------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def jax_device_run(case):  # noqa: F811
    """The JAX device path in "exact": its labels, the JAX CNN's logit
    margin (top-1 minus top-2) per voxel of the full volume (inf outside
    the CNN's crop) and its chain's outputs."""
    raw_case, gnn_ckpt, cnn_ckpt = case
    *_, gfwd = jax_load_gnn(gnn_ckpt)
    *_, cfwd = jax_load_cnn(cnn_ckpt)
    seen = {"axes": []}
    axis_indices, chain = jax_common._axis_indices, slic_tpu.serve_preprocess_tpu

    def axes_capture(*args, **kw):
        out = axis_indices(*args, **kw)
        seen["axes"].append(out[2])
        return out

    def chain_capture(*args, **kw):
        seen["chain"] = chain(*args, **kw)
        return seen["chain"]

    def cnn_capture(x):
        out = cfwd(x)
        seen["refined"] = np.asarray(out)[0]
        return out

    with pytest.MonkeyPatch.context() as mp, jax_precision("exact"):
        mp.setattr(jax_common, "_axis_indices", axes_capture)
        mp.setattr(slic_tpu, "serve_preprocess_tpu", chain_capture)
        labels = jax_predict(str(raw_case), gfwd, cnn_capture,
                             num_nodes=NUM_NODES, num_neighbors=K,
                             prep_impl="device", pad_shape=None)
    rx, ry, rz = seen["axes"][-3:]
    top = np.sort(seen["refined"][:len(rx), :len(ry), :len(rz)], axis=-1)
    img = jax_nifti.read_in_patient_sample(str(raw_case), ["_flair.nii.gz",
                                                          "_t1.nii.gz", "_t1ce.nii.gz",
                                                          "_t2.nii.gz"])
    crop = jax_image.determine_brain_crop(img)
    brain = np.full(tuple(ix.size for ix in crop), np.inf, np.float32)
    brain[np.ix_(rx, ry, rz)] = top[..., -1] - top[..., -2]
    margin = np.full(img.shape[:3], np.inf, np.float32)
    margin[crop] = brain
    return labels, margin, seen["chain"]


def _port_predict(case, mode, **kw):  # noqa: F811
    raw_case, gnn_ckpt, cnn_ckpt = case
    _, _, gfwd = load_gnn_from_checkpoint(gnn_ckpt, device="cpu")
    _, _, cfwd = load_cnn_from_checkpoint(cnn_ckpt, device="cpu")
    with precision_scope(mode):
        return port_cli.predict_single_mri(str(raw_case), gfwd, cfwd,
                                           num_nodes=NUM_NODES, num_neighbors=K,
                                           **kw)


@pytest.mark.parametrize("mode,bar", [("exact", 0.999), ("fast", 0.9)])
def test_device_prep_serve_matches_host_prep(case, mode, bar):  # noqa: F811
    times = {}
    dev = _port_predict(case, mode, prep_impl="device", device="cpu",
                        stage_times=times)
    host = _port_predict(case, mode, cnn_prep="host")
    assert dev.shape == host.shape and dev.dtype == np.int16
    assert set(np.unique(dev)) <= {0, 1, 2, 4}
    assert (dev == host).mean() >= bar
    assert {"slic_device", "connectivity", "stats_knn", "graph_build",
            "normalize", "nifti_read", "gnn_forward", "crop_and_prep",
            "cnn_forward"} <= set(times)


def test_device_prep_serve_matches_jax_device_path(case, jax_device_run):  # noqa: F811
    want, _, _ = jax_device_run
    got = _port_predict(case, "exact", prep_impl="device", device="cpu")
    assert (got == want).mean() >= 0.999


def test_port_serve_on_the_jax_chain_matches_jax(case, jax_device_run,  # noqa: F811
                                                  monkeypatch):
    """The port's serve path, fed the JAX chain's raw labels and
    standardized volume, gives the JAX device path's labels up to the JAX
    CNN's near-ties."""
    want, margin, (lj, dev_std, qj, step_j) = jax_device_run
    vol = torch.from_numpy(np.ascontiguousarray(
        np.asarray(dev_std).transpose(0, 1, 3, 2)))
    monkeypatch.setattr(slic_device, "serve_preprocess_device",
                        lambda *a, **kw: (lj, vol, qj, step_j))
    got = _port_predict(case, "exact", prep_impl="device", device="cpu")
    differ = np.argwhere(got != want)
    for v in map(tuple, differ):
        print(f"voxel {v}: port {got[v]} jax {want[v]} "
              f"jax logit margin {margin[v]:.3g}")
    assert all(margin[tuple(v)] < MARGIN_TOL for v in differ), (
        f"{len(differ)} voxels differ where the JAX margin is >= {MARGIN_TOL}")


# ----------------------------------------------------------------------- bulk


def _artifacts(out, sid):
    d = out / sid
    return {"input": nifti.read_nifti(str(d / f"{sid}_input.nii.gz"), np.float32),
            "sv": nifti.read_nifti(str(d / f"{sid}_supervoxels.nii.gz"), np.int16),
            "label": nifti.read_nifti(str(d / f"{sid}_label.nii.gz"), np.int16),
            "sample": store.load_graph_npz(str(d / f"{sid}_graph.npz"))}


def test_device_preprocessor_matches_host_path(tmp_path):
    """DataPreprocessor(prep_impl='device') against the host path pinned to
    the device SLIC (--slic_impl tpu) and against the JAX device path."""
    raw = tmp_path / "raw"
    make_fake_brats_dir(raw, n_samples=1, seed=44)
    kw = dict(num_nodes=250, num_neighbors=6, boxiness=0.5,
              label_extension="_seg.nii.gz", n_threads=1)
    runs = {"device": DataPreprocessor(str(raw), str(tmp_path / "device"),
                                       prep_impl="device", device="cpu", **kw),
            "host": DataPreprocessor(str(raw), str(tmp_path / "host"),
                                     slic_fn=resolve_slic_fn("tpu", device="cpu"),
                                     **kw),
            "jax": JaxPreprocessor(str(raw), str(tmp_path / "jax"),
                                   prep_impl="device", pad_shape=None, **kw)}
    out = {}
    for name, pre in runs.items():
        done = pre.run()
        assert len(done) == 1
        out[name] = _artifacts(tmp_path / name, done[0])
    dv, h = out["device"], out["host"]
    assert np.array_equal(dv["input"], h["input"])
    assert np.array_equal(dv["input"], out["jax"]["input"])
    assert np.array_equal(dv["sv"], h["sv"]) and np.array_equal(dv["label"], h["label"])
    assert np.array_equal(dv["sample"].src, h["sample"].src)
    assert np.array_equal(dv["sample"].dst, h["sample"].dst)
    assert np.array_equal(dv["sample"].labels, h["sample"].labels)
    np.testing.assert_allclose(dv["sample"].feats, h["sample"].feats, atol=2e-5)


# --------------------------------------------------------------------- warmup


def test_warmup_runs_on_the_cpu(case, tmp_path, monkeypatch, capsys):  # noqa: F811
    _, gnn_ckpt, cnn_ckpt = case
    monkeypatch.setattr(warmup, "WARMUP_SHAPE", (96, 48, 40))
    with precision_scope("exact"):     # warmup sets the process-wide mode
        warmup.main(["-g", gnn_ckpt, "-c", cnn_ckpt, "-n", "200",
                     "--slic_impl", "tpu", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Built gts_native.cc (g++)" in out
    assert "ran one request (device preprocessing)" in out and "(96, 48, 40)" in out
