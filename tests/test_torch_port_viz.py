"""viz/ and the two plot CLIs of the port against the JAX package's, on the
host: the overlays and the colour table bitwise equal, `plot_pred_slices
--save` writing a PNG under Agg, the viewer's j/k scroll headless (as
tests/test_viz.py), and no matplotlib imported by importing the port's
viz/ and plot CLI modules.
"""

import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from gnn_tumor_seg_tpu.viz import helpers as jax_helpers
from gnn_tumor_seg_tpu_torch.data import nifti
from gnn_tumor_seg_tpu_torch.viz import helpers, volume_viewer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(tmp_path, shape, mri_id="case1", seed=1):
    """A raw BraTS-style folder (FLAIR, T1CE, seg) and a prediction."""
    rng = np.random.default_rng(seed)
    case = tmp_path / "raw" / mri_id
    case.mkdir(parents=True)
    for ext in ("_flair.nii.gz", "_t1ce.nii.gz"):
        nifti.write_nifti(rng.random(shape).astype(np.float32),
                          str(case / f"{mri_id}{ext}"))
    nifti.write_nifti(rng.choice([0, 1, 2, 4], shape).astype(np.int16),
                      str(case / f"{mri_id}_seg.nii.gz"))
    seg = tmp_path / "preds"
    seg.mkdir()
    nifti.write_nifti(rng.choice([0, 1, 2, 4], shape).astype(np.int16),
                      str(seg / f"{mri_id}.nii.gz"))
    return str(tmp_path / "raw"), str(seg)


@pytest.mark.parametrize("continuous", [False, True])
def test_label_lut_and_overlay_are_jax_bitwise(continuous):
    lut, jlut = helpers.label_lut(continuous), jax_helpers.label_lut(continuous)
    assert lut.dtype == jlut.dtype and np.array_equal(lut, jlut)
    rng = np.random.default_rng(0)
    base = rng.random((9, 8, 5)).astype(np.float32)
    labels = rng.choice([0, 1, 2, 3, 4] if not continuous else [0, 1, 2, 3],
                        base.shape).astype(np.int16)
    got, want = helpers.overlay_labels(base, labels, lut), \
        jax_helpers.overlay_labels(base, labels, jlut)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shape,read_labels", [((240, 240, 6), True),
                                               ((20, 18, 6), False)],
                         ids=["zoomed-gt", "small-nogt"])
def test_load_plotting_data_is_jax_bitwise(tmp_path, shape, read_labels):
    raw, seg = _case(tmp_path, shape)
    got = helpers.load_plotting_data(raw, seg, "case1", read_labels=read_labels)
    want = jax_helpers.load_plotting_data(raw, seg, "case1",
                                          read_labels=read_labels)
    zoomed = shape[0] >= 220
    assert got[0].shape == ((190, 190, 6) if zoomed else shape)
    assert got[2].shape == got[0].shape + (3,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_plot_slices_cli_saves(tmp_path):
    from gnn_tumor_seg_tpu_torch.cli import plot_pred_slices

    raw, seg = _case(tmp_path, (240, 240, 155))
    out = tmp_path / "fig.png"
    plot_pred_slices.main(["-d", raw, "-s", seg, "-i", "case1", "-l",
                           "--save", str(out)])
    assert out.exists() and out.stat().st_size > 1000
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_volume_viewer_headless_scroll():
    vols = [{"arr": np.random.default_rng(0).random((6, 6, 5)), "cmap": "gray",
             "stride": 1, "title": f"v{i}"} for i in range(3)]
    fig = volume_viewer.multi_slice_viewer(vols, show=False)
    ax = [a for a in fig.axes if hasattr(a, "volume")][0]
    start = ax.index

    class FakeEvent:
        def __init__(self, key, canvas):
            self.key = key
            self.canvas = canvas

    volume_viewer._process_key(FakeEvent("k", fig.canvas))
    assert ax.index == (start + 1) % 5
    volume_viewer._process_key(FakeEvent("j", fig.canvas))
    assert ax.index == start


def test_cmaps_construct():
    cm, lut = helpers.label_cmap(True)
    assert lut.shape == (4, 3) and cm.N == 4
    sv = np.arange(12).reshape(3, 4) - 1
    assert helpers.cluster_cmap(sv, seed=0).N == 11


def test_import_leaves_matplotlib_out(tmp_path):
    """Importing viz/ and the two plot CLIs, and building an overlay, imports
    no matplotlib (the machine with the card has none)."""
    raw, seg = _case(tmp_path, (20, 18, 6))
    code = (
        "import sys\n"
        "from gnn_tumor_seg_tpu_torch.viz import helpers, volume_viewer\n"
        "from gnn_tumor_seg_tpu_torch.cli import plot_pred_slices, plot_pred_volume\n"
        f"out = helpers.load_plotting_data({raw!r}, {seg!r}, 'case1')\n"
        "assert out[2].shape == (20, 18, 6, 3)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'matplotlib'))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
