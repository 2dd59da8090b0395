"""CLI: single-MRI end-to-end prediction (the containerized deployment contract),
on the GPU (counterpart of gnn_tumor_seg_tpu/cli/predict_single.py).

An input directory with one MRI's four modalities `*_{flair,t1,t1ce,t2}.nii.gz`
produces `<output>/<id>.nii.gz` with BraTS labels and the standard affine:
preprocess in memory, the GNN forward of the checkpoint's model (GSpool,
GSmean, GSgcn or GAT, through the Hopper kernels), CNN refinement, uncrop,
label swap, save. With --prep_impl device (the default with --slic_impl tpu)
normalization, standardization, smoothing and SLIC run on the card from one
upload of the raw crop (ops/slic_device.py), and the standardized volume
stays there for the CNN.

Run: python -m gnn_tumor_seg_tpu_torch.cli.predict_single -i /input -o /output \
        -g gnn.ckpt -c cnn.ckpt [--slic_impl tpu] [--prep_impl device] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import spans
from ..config import DEFAULT_MODALITY_EXTS, STANDARDIZATION_STATS
from ..data import nifti
from ..data.graph_build import build_graph_sample, sample_from_partition
from ..data.image import (determine_brain_crop, normalize_img, standardize_img,
                          swap_labels_to_brats, uncrop_to_brats_size)
from ..ops.graph import graph_from_arrays
from ..runtime import resolve_device
from .common import (load_cnn_from_checkpoint, load_gnn_from_checkpoint,
                     predict_one_sample, predict_one_sample_device,
                     resolve_slic_fn, ship_partition)


def predict_single_mri(input_dir: str, gnn_forward, cnn_forward,
                       num_nodes: int = 15000, num_neighbors: int | None = 10,
                       boxiness: float = 0.5,
                       modality_exts=None, slic_fn=None,
                       stage_times: dict | None = None,
                       cnn_prep: str = "device", prep_impl: str = "host",
                       device="cuda") -> np.ndarray:
    """Full chain for one MRI directory -> BraTS-labelled full-size volume.

    gnn_forward and cnn_forward come from cli/common.load_*_from_checkpoint
    and carry the device. stage_times, when given, is filled with the
    seconds of each stage, each from its span (spans.py, "serve.<key>"):
    nifti_read, normalize (holding brain_crop), graph_build (holding, on
    the host path, slic_host and, on both, stats and knn; on the device
    path also slic_device, connectivity and stats_knn), gnn_forward,
    crop_and_prep, cnn_forward, output, and request, the whole call; with
    n_nodes and cnn_crop_shape. The request is one unit of the spans'
    timeline (recent("serve.request") holds its stage_times).
    cnn_prep='device' (default) keeps the GNN logits on the card and
    gathers the CNN input crop there; 'host' builds it on the host. Both
    give the same labels.

    prep_impl='device' runs the preprocessing on `device` (the card unless
    the caller asks for the CPU): ops/slic_device.serve_preprocess_device
    normalizes, standardizes, smooths and assigns supervoxels from one
    upload of the raw crop, the standardized volume stays there for the
    CNN, and the host computes the graph features from the raw crop through
    the equivalent affine map (quantiles commute with positive affines).
    It implies device SLIC and device CNN prep; slic_fn and cnn_prep are
    unused there."""
    if cnn_prep not in ("device", "host"):
        raise ValueError(f"cnn_prep must be 'device' or 'host', got {cnn_prep!r}")
    if prep_impl not in ("device", "host"):
        raise ValueError(f"prep_impl must be 'device' or 'host', got {prep_impl!r}")
    st = stage_times
    modality_exts = modality_exts or DEFAULT_MODALITY_EXTS
    with spans.unit("serve.request", st, "request"):
        with spans.span("serve.nifti_read", st, "nifti_read"):
            image = nifti.read_in_patient_sample(input_dir, modality_exts)
        with spans.span("serve.normalize", st, "normalize"):
            mean = np.asarray(STANDARDIZATION_STATS[0], np.float32)
            std = np.asarray(STANDARDIZATION_STATS[1], np.float32)
            with spans.span("serve.brain_crop", st, "brain_crop"):
                crop = determine_brain_crop(image)
                cropped = image[crop]
            if prep_impl == "device":
                from ..ops.precision import fast_precision
                from ..ops.slic_device import finalize_labels, serve_preprocess_device

                dev = resolve_device(device)
                input_dtype = torch.bfloat16 if fast_precision() else torch.float32
            else:
                standardized = standardize_img(normalize_img(cropped), mean, std)
        with spans.span("serve.graph_build", st, "graph_build"):
            if prep_impl == "device":
                with spans.span("serve.slic_device", st, "slic_device"):
                    labels_raw, vol, q, step = serve_preprocess_device(
                        cropped, num_nodes, boxiness, mean, std, sigma=1.0,
                        input_dtype=input_dtype, device=dev)
                with spans.span("serve.connectivity", st, "connectivity"):
                    sv = finalize_labels(labels_raw, step)
                with spans.span("serve.stats_knn", st, "stats_knn"):
                    # the raw partition streams to the card while the host
                    # computes the segment stats and kNN; the discard's
                    # renumbering, known only after them, is applied there
                    # through sample.sv_remap
                    sv_dev = ship_partition(sv, int(sv.max()) + 1, dev)
                    # standardized = raw / (q * std) - mean / std per modality
                    a = (1.0 / (q * std)).astype(np.float32)
                    b = (-mean / std).astype(np.float32)
                    sample = sample_from_partition(cropped, None, sv, num_neighbors,
                                                   feat_affine=(a, b),
                                                   stage_times=st)
                    graph = graph_from_arrays(sample.feats, sample.src, sample.dst)
            else:
                sample = build_graph_sample(standardized, None, num_nodes, boxiness,
                                            num_neighbors, slic_fn=slic_fn,
                                            stage_times=st)
                graph = graph_from_arrays(sample.feats, sample.src, sample.dst)
        if st is not None:
            st["n_nodes"] = int(graph.n_nodes[0])
        if prep_impl == "device":
            pred = predict_one_sample_device(
                gnn_forward, cnn_forward, graph, None, sample.sv_partition,
                stage_times=st, vol_t=vol, sv_raw_dev=sv_dev,
                sv_remap=sample.sv_remap)
        else:
            predict = (predict_one_sample_device if cnn_prep == "device"
                       else predict_one_sample)
            pred = predict(gnn_forward, cnn_forward, graph, standardized,
                           sample.sv_partition, stage_times=st)
        with spans.span("serve.output", st, "output"):
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
                   help="supervoxelization backend; 'tpu' (the JAX "
                        "package's name) smooths and assigns on the card "
                        "(--device); see also --prep_impl")
    p.add_argument("--cnn_prep", default="device", choices=("device", "host"),
                   help="where the CNN input crop is assembled; 'device' "
                        "keeps the GNN logits on the card")
    p.add_argument("--prep_impl", default="auto",
                   choices=("auto", "host", "device"),
                   help="where normalization, smoothing and SLIC run; "
                        "'device' runs them on the card from one upload of "
                        "the raw crop and keeps the standardized volume "
                        "there for the CNN; 'auto' = device when "
                        "--slic_impl tpu")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cpu' runs every kernel's plain PyTorch version")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..ops.precision import set_precision_mode

    set_precision_mode(args.precision)
    _, _, gnn_forward = load_gnn_from_checkpoint(
        os.path.expanduser(args.gnn_weights), device=args.device)
    _, _, cnn_forward = load_cnn_from_checkpoint(
        os.path.expanduser(args.cnn_weights), device=args.device)
    input_dir = os.path.expanduser(args.input_dir)
    prep_impl = args.prep_impl
    if prep_impl == "auto":
        prep_impl = "device" if args.slic_impl == "tpu" else "host"
    pred = predict_single_mri(
        input_dir, gnn_forward, cnn_forward,
        num_nodes=args.num_nodes,
        num_neighbors=args.num_neighbors or None,
        boxiness=args.boxiness,
        modality_exts=args.modality_extensions,
        slic_fn=resolve_slic_fn(args.slic_impl, device=args.device),
        cnn_prep=args.cnn_prep,
        prep_impl=prep_impl,
        device=args.device,
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
