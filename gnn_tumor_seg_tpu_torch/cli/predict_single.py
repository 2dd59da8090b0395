"""CLI: single-MRI end-to-end prediction (the containerized deployment contract),
on the GPU (counterpart of gnn_tumor_seg_tpu/cli/predict_single.py).

An input directory with one MRI's four modalities `*_{flair,t1,t1ce,t2}.nii.gz`
produces `<output>/<id>.nii.gz` with BraTS labels and the standard affine:
preprocess in memory, the GNN forward of the checkpoint's model (GSpool,
GSmean, GSgcn or GAT, through the Hopper kernels), CNN refinement, uncrop,
label swap, save.

Run: python -m gnn_tumor_seg_tpu_torch.cli.predict_single -i /input -o /output \
        -g gnn.ckpt -c cnn.ckpt [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..config import DEFAULT_MODALITY_EXTS, STANDARDIZATION_STATS
from ..data import nifti
from ..data.graph_build import build_graph_sample
from ..data.image import (determine_brain_crop, normalize_img, standardize_img,
                          swap_labels_to_brats, uncrop_to_brats_size)
from ..ops.graph import graph_from_arrays
from .common import (load_cnn_from_checkpoint, load_gnn_from_checkpoint,
                     predict_one_sample, predict_one_sample_device,
                     resolve_slic_fn)


def predict_single_mri(input_dir: str, gnn_forward, cnn_forward,
                       num_nodes: int = 15000, num_neighbors: int | None = 10,
                       boxiness: float = 0.5,
                       modality_exts=None, slic_fn=None,
                       stage_times: dict | None = None,
                       cnn_prep: str = "device") -> np.ndarray:
    """Full chain for one MRI directory -> BraTS-labelled full-size volume.

    gnn_forward and cnn_forward come from cli/common.load_*_from_checkpoint
    and carry the device. stage_times, when given, is filled with per-stage
    wall-clock of this run. cnn_prep='device' (default) keeps the GNN logits
    on the card and gathers the CNN input crop there; 'host' builds it on
    the host. Both give the same labels."""
    if cnn_prep not in ("device", "host"):
        raise ValueError(f"cnn_prep must be 'device' or 'host', got {cnn_prep!r}")
    rec = time.perf_counter
    modality_exts = modality_exts or DEFAULT_MODALITY_EXTS
    t0 = rec()
    image = nifti.read_in_patient_sample(input_dir, modality_exts)
    t1 = rec()
    mean = np.asarray(STANDARDIZATION_STATS[0], np.float32)
    std = np.asarray(STANDARDIZATION_STATS[1], np.float32)
    crop = determine_brain_crop(image)
    standardized = standardize_img(normalize_img(image[crop]), mean, std)
    t2 = rec()
    sample = build_graph_sample(standardized, None, num_nodes, boxiness,
                                num_neighbors, slic_fn=slic_fn)
    graph = graph_from_arrays(sample.feats, sample.src, sample.dst)
    t3 = rec()
    predict = (predict_one_sample_device if cnn_prep == "device"
               else predict_one_sample)
    pred = predict(gnn_forward, cnn_forward, graph, standardized,
                   sample.sv_partition, stage_times=stage_times)
    if stage_times is not None:
        stage_times["nifti_read"] = t1 - t0
        stage_times["normalize"] = t2 - t1
        stage_times["graph_build"] = t3 - t2
        stage_times["n_nodes"] = int(graph.n_nodes[0])
    pred = uncrop_to_brats_size(crop, pred, shape=image.shape[:3])
    return swap_labels_to_brats(pred)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--input_dir", default="/input", type=str,
                   help="directory containing one MRI's modality files")
    p.add_argument("-o", "--output_dir", default="/output", type=str)
    p.add_argument("-g", "--gnn_weights", required=True, type=str)
    p.add_argument("-c", "--cnn_weights", required=True, type=str)
    p.add_argument("-n", "--num_nodes", default=15000, type=int)
    p.add_argument("-k", "--num_neighbors", default=10, type=int)
    p.add_argument("-b", "--boxiness", default=0.5, type=float)
    p.add_argument("-m", "--modality_extensions", nargs="+",
                   default=DEFAULT_MODALITY_EXTS)
    p.add_argument("--precision", default="exact", choices=("exact", "fast"),
                   help="'fast' runs the GNN and CNN with bf16 activations")
    p.add_argument("--slic_impl", default="auto",
                   choices=("auto", "native", "numpy", "tpu"),
                   help="supervoxelization backend; 'tpu' (device SLIC) is "
                        "not ported yet")
    p.add_argument("--cnn_prep", default="device", choices=("device", "host"),
                   help="where the CNN input crop is assembled; 'device' "
                        "keeps the GNN logits on the card")
    p.add_argument("--prep_impl", default="auto",
                   choices=("auto", "host", "device"),
                   help="where normalization runs; 'device' (the JAX "
                        "package's device preprocess) is not ported yet")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cpu' runs every kernel's plain PyTorch version")
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.slic_impl == "tpu" or args.prep_impl == "device":
        parser.error("--slic_impl tpu and --prep_impl device need the device "
                     "preprocess chain (gnn_tumor_seg_tpu/ops/slic_tpu.py), "
                     "which the port does not have yet (ROADMAP.md)")
    from ..ops.precision import set_precision_mode

    set_precision_mode(args.precision)
    _, _, gnn_forward = load_gnn_from_checkpoint(
        os.path.expanduser(args.gnn_weights), device=args.device)
    _, _, cnn_forward = load_cnn_from_checkpoint(
        os.path.expanduser(args.cnn_weights), device=args.device)
    input_dir = os.path.expanduser(args.input_dir)
    pred = predict_single_mri(
        input_dir, gnn_forward, cnn_forward,
        num_nodes=args.num_nodes,
        num_neighbors=args.num_neighbors or None,
        boxiness=args.boxiness,
        modality_exts=args.modality_extensions,
        slic_fn=resolve_slic_fn(args.slic_impl),
        cnn_prep=args.cnn_prep,
    )
    output_dir = os.path.expanduser(args.output_dir)
    os.makedirs(output_dir, exist_ok=True)
    # name the output after the modality files' shared prefix, else 'prediction'
    mri_id = "prediction"
    for f in sorted(os.listdir(input_dir)):
        for ext in args.modality_extensions:
            if f.endswith(ext):
                mri_id = f[: -len(ext)]
                break
        if mri_id != "prediction":
            break
    out_fp = os.path.join(output_dir, f"{mri_id}.nii.gz")
    nifti.save_as_nifti(pred, out_fp)
    print(f"Saved prediction to {out_fp}")


if __name__ == "__main__":
    main()
