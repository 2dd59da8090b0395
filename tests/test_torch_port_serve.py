"""Single-MRI serve path: the port against the JAX package, end to end, on the CPU.

The 32x32x24 fake BraTS case of tests/test_pipeline_e2e.py, num_nodes=250,
k=6, with GTS_CNN_CROP_FLOOR=none as tests/conftest.py sets it; both packages
load the same checkpoint files (written by the JAX package).

Tolerances:
  * host preprocessing (NIfTI read, normalization, SLIC partition, graph
    features, edge order, ELL table): identical, for --slic_impl numpy and
    native;
  * labels of predict_single_mri in "exact" mode: identical, for both
    cnn_prep values. A voxel may differ only where the JAX CNN's logit
    margin (top-1 minus top-2) is below 1e-4 there, a near-tie that float32
    summation order can flip; each such voxel is printed.
"""

from functools import partial

import jax
import numpy as np
import pytest

from gnn_tumor_seg_tpu.cli.common import (load_cnn_from_checkpoint as jax_load_cnn,
                                          load_gnn_from_checkpoint as jax_load_gnn,
                                          node_logits_to_voxel_logits as jax_n2v)
from gnn_tumor_seg_tpu.cli.predict_single import predict_single_mri as jax_predict
from gnn_tumor_seg_tpu.config import HyperParams as JaxHyperParams
from gnn_tumor_seg_tpu.data import graph_build as jax_gb
from gnn_tumor_seg_tpu.data import image as jax_image
from gnn_tumor_seg_tpu.data import nifti as jax_nifti
from gnn_tumor_seg_tpu.data import slic as jax_slic
from gnn_tumor_seg_tpu.data.preprocess import (DEFAULT_MODALITY_EXTS,
                                               STANDARDIZATION_STATS)
from gnn_tumor_seg_tpu.models.refine_cnn import CnnRefinementNet as JaxCnn
from gnn_tumor_seg_tpu.models.sage import GraphSage as JaxGraphSage
from gnn_tumor_seg_tpu.ops.graph import graph_from_arrays as jax_graph_from_arrays
from gnn_tumor_seg_tpu.ops.pallas.precision import precision_scope as jax_precision
from gnn_tumor_seg_tpu.train.checkpoint import save_checkpoint as jax_save
from gnn_tumor_seg_tpu_torch import config as port_config
from gnn_tumor_seg_tpu_torch.cli import predict_single as port_cli
from gnn_tumor_seg_tpu_torch.cli.common import (load_cnn_from_checkpoint,
                                                load_gnn_from_checkpoint)
from gnn_tumor_seg_tpu_torch.data import graph_build, image, nifti, slic
from gnn_tumor_seg_tpu_torch.ops.graph import graph_from_arrays
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from tests.test_pipeline_e2e import SHAPE, make_fake_brats_dir

NUM_NODES, K = 250, 6
MARGIN_TOL = 1e-4


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_serve")
    make_fake_brats_dir(root / "raw", n_samples=1, with_labels=False, seed=21)
    raw_case = next((root / "raw").iterdir())
    gnn_ckpt, cnn_ckpt = str(root / "gnn.ckpt"), str(root / "cnn.ckpt")
    hp = JaxHyperParams(layer_sizes=[16, 16])
    # key 0 labels 34 of this case's 172 nodes as tumor, so the CNN runs on
    # a real tumor crop (other keys label everything or nothing)
    jax_save(gnn_ckpt, JaxGraphSage(20, [16, 16], 4, "pool").init(
        jax.random.PRNGKey(0)), "GSpool", hp)
    jax_save(cnn_ckpt, JaxCnn(8, 4, [8]).init(jax.random.PRNGKey(8)), "CNN",
             JaxHyperParams(in_feats=8, layer_sizes=[8]))
    return raw_case, gnn_ckpt, cnn_ckpt


def _standardized(nifti_mod, image_mod, raw_case, stats):
    img = nifti_mod.read_in_patient_sample(str(raw_case), DEFAULT_MODALITY_EXTS)
    crop = image_mod.determine_brain_crop(img)
    mean = np.asarray(stats[0], np.float32)
    std = np.asarray(stats[1], np.float32)
    return img, crop, image_mod.standardize_img(
        image_mod.normalize_img(img[crop]), mean, std)


def test_constants_match_jax():
    assert port_config.STANDARDIZATION_STATS == STANDARDIZATION_STATS
    assert port_config.DEFAULT_MODALITY_EXTS == DEFAULT_MODALITY_EXTS


@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
def test_preprocess_and_graph_match_jax(case, use_native):
    raw_case, _, _ = case
    img_j, crop_j, std_j = _standardized(jax_nifti, jax_image, raw_case,
                                         STANDARDIZATION_STATS)
    img_t, crop_t, std_t = _standardized(nifti, image, raw_case,
                                         port_config.STANDARDIZATION_STATS)
    assert np.array_equal(img_t, img_j)
    assert all(np.array_equal(a, b) for a, b in zip(crop_t, crop_j))
    assert np.array_equal(std_t, std_j)
    sj = jax_gb.build_graph_sample(
        std_j, None, NUM_NODES, 0.5, K,
        slic_fn=partial(jax_slic.slic_supervoxels, use_native=use_native))
    st = graph_build.build_graph_sample(
        std_t, None, NUM_NODES, 0.5, K,
        slic_fn=partial(slic.slic_supervoxels, use_native=use_native))
    assert np.array_equal(st.sv_partition, sj.sv_partition)
    assert np.array_equal(st.feats, sj.feats)
    assert np.array_equal(st.src, sj.src) and np.array_equal(st.dst, sj.dst)
    gj = jax_graph_from_arrays(sj.feats, sj.src, sj.dst)
    gt = graph_from_arrays(st.feats, st.src, st.dst)
    assert np.array_equal(gt.nbr.numpy(), np.asarray(gj.nbr))
    assert np.array_equal(gt.nbr_mask.numpy(), np.asarray(gj.nbr_mask))


@pytest.fixture(scope="module")
def jax_reference(case):
    """JAX labels (exact mode, host CNN prep), the JAX CNN's logit margin
    per voxel of the full volume (inf outside the CNN's crop), the tumor
    crop's shape and the brain crop's shape."""
    raw_case, gnn_ckpt, cnn_ckpt = case
    *_, gfwd = jax_load_gnn(gnn_ckpt)
    *_, cfwd = jax_load_cnn(cnn_ckpt)
    seen = {}

    def gnn_capture(graph):
        seen["node_logits"] = np.asarray(gfwd(graph))[0]
        return gfwd(graph)

    def cnn_capture(x):
        out = cfwd(x)
        seen["refined"] = np.asarray(out)[0]
        return out

    with jax_precision("exact"):
        labels = jax_predict(str(raw_case), gnn_capture, cnn_capture,
                             num_nodes=NUM_NODES, num_neighbors=K,
                             cnn_prep="host")
    # rebuild the crops the JAX chain used, from its own host helpers
    img, crop, std = _standardized(jax_nifti, jax_image, raw_case,
                                   STANDARDIZATION_STATS)
    sample = jax_gb.build_graph_sample(std, None, NUM_NODES, 0.5, K)
    n = sample.feats.shape[0]
    vox = jax_n2v(seen["node_logits"][:n], sample.sv_partition)
    tumor_crop = jax_image.determine_tumor_crop(vox.argmax(-1))
    dims = tuple(ix.size for ix in tumor_crop)
    top = np.sort(seen["refined"][:dims[0], :dims[1], :dims[2]], axis=-1)
    margin_brain = np.full(sample.sv_partition.shape, np.inf, np.float32)
    margin_brain[tumor_crop] = top[..., -1] - top[..., -2]
    margin = np.full(img.shape[:3], np.inf, np.float32)
    margin[crop] = margin_brain
    return labels, margin, list(dims), sample.sv_partition.shape


@pytest.mark.parametrize("cnn_prep", ["device", "host"])
def test_predict_single_mri_matches_jax(case, jax_reference, cnn_prep):
    raw_case, gnn_ckpt, cnn_ckpt = case
    want, margin, jax_crop, brain_shape = jax_reference
    _, _, gfwd = load_gnn_from_checkpoint(gnn_ckpt, device="cpu")
    _, _, cfwd = load_cnn_from_checkpoint(cnn_ckpt, device="cpu")
    stage_times = {}
    with precision_scope("exact"):
        got = port_cli.predict_single_mri(str(raw_case), gfwd, cfwd,
                                          num_nodes=NUM_NODES, num_neighbors=K,
                                          cnn_prep=cnn_prep,
                                          stage_times=stage_times)
    assert got.shape == want.shape == SHAPE and got.dtype == np.int16
    # the same tumor crop as the JAX chain, and smaller than the brain
    assert stage_times["cnn_crop_shape"] == jax_crop
    assert np.prod(jax_crop) < np.prod(brain_shape)
    assert set(np.unique(got)) <= {0, 1, 2, 4}
    assert {"nifti_read", "normalize", "graph_build", "gnn_forward",
            "crop_and_prep", "cnn_forward", "n_nodes",
            "cnn_crop_shape"} <= set(stage_times)
    differ = np.argwhere(got != want)
    for v in map(tuple, differ):
        print(f"voxel {v}: port {got[v]} jax {want[v]} "
              f"jax logit margin {margin[v]:.3g}")
    assert all(margin[tuple(v)] < MARGIN_TOL for v in differ), (
        f"{len(differ)} voxels differ where the JAX margin is >= {MARGIN_TOL}")


def test_cli_main_writes_nifti(case, tmp_path):
    raw_case, gnn_ckpt, cnn_ckpt = case
    port_cli.main(["-i", str(raw_case), "-o", str(tmp_path), "-g", gnn_ckpt,
                   "-c", cnn_ckpt, "-n", str(NUM_NODES), "-k", str(K),
                   "--slic_impl", "native", "--device", "cpu"])
    out = list(tmp_path.iterdir())
    assert [p.name for p in out] == ["case.nii.gz"]
    pred = nifti.read_nifti(str(out[0]), np.int16)
    assert pred.shape == SHAPE and set(np.unique(pred)) <= {0, 1, 2, 4}


@pytest.mark.parametrize("flags", [["--slic_impl", "tpu"],
                                   ["--prep_impl", "device"]])
def test_cli_rejects_unported_device_preprocess(case, tmp_path, flags, capsys):
    raw_case, gnn_ckpt, cnn_ckpt = case
    with pytest.raises(SystemExit):
        port_cli.main(["-i", str(raw_case), "-o", str(tmp_path), "-g", gnn_ckpt,
                       "-c", cnn_ckpt, "--device", "cpu", *flags])
    assert "not have yet" in capsys.readouterr().err
