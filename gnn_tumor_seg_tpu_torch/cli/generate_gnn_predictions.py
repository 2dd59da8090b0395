"""CLI: run a trained GNN over preprocessed graphs and export voxel volumes, on
one device (counterpart of gnn_tumor_seg_tpu/cli/generate_gnn_predictions.py).

Argument contract of `scripts/generate_gnn_predictions.py:76-100` and of the
JAX package's CLI, plus --device. The output is per-voxel logit volumes
(-f logits, `<id>_logits.nii.gz`, what the refinement CNN trains on) or
uncropped predictions in BraTS labels (-f preds, `<id>.nii.gz`). The model
(GSpool, GSmean, GSgcn or GAT) is rebuilt from the checkpoint's embedded
config; its forward goes through the Hopper kernels on the card, in the
precision mode GTS_PALLAS_PRECISION names ("exact" when unset), as for the
JAX package.

  python -m gnn_tumor_seg_tpu_torch.cli.generate_gnn_predictions -d <processed> \\
      -o <out> -w <ckpt> [-f logits|preds] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

from ..data import nifti
from ..data.dataset import ImageGraphDataset
from ..data.image import (project_nodes_to_img, swap_labels_to_brats,
                          uncrop_to_brats_size)
from ..ops.precision import precision_scope
from .common import load_gnn_from_checkpoint, node_logits_to_voxel_logits

__all__ = ["main", "build_parser", "save_predictions"]


def save_voxel_logits(output_dir, mri_id, dataset, node_logits):
    sv = dataset.get_supervoxel_partitioning(mri_id)
    voxel_logits = node_logits_to_voxel_logits(node_logits, sv)
    nifti.save_as_nifti(voxel_logits,
                        os.path.join(output_dir, f"{mri_id}_logits.nii.gz"))


def save_voxel_preds(output_dir, mri_id, dataset, node_logits):
    node_preds = node_logits.argmax(-1)
    sv = dataset.get_supervoxel_partitioning(mri_id)
    crop = dataset.get_crop(mri_id)
    voxels = project_nodes_to_img(sv, node_preds)
    voxels = uncrop_to_brats_size(crop, voxels,
                                  shape=dataset.get_orig_shape(mri_id))
    voxels = swap_labels_to_brats(voxels)
    nifti.save_as_nifti(voxels, os.path.join(output_dir, f"{mri_id}.nii.gz"))


def save_predictions(forward, dataset, output_dir, save_format="logits"):
    """forward(graph) -> node logits [1, N, C] (cli/common.py)."""
    if save_format not in ("preds", "logits"):
        raise ValueError(f"Unrecognized save format {save_format}")
    save = save_voxel_preds if save_format == "preds" else save_voxel_logits
    for i, mri_id in enumerate(dataset.ids):
        g = dataset.get_graph(i)
        node_logits = forward(g)[0, : int(g.n_nodes[0])].float().cpu().numpy()
        save(output_dir, mri_id, dataset, node_logits)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--data_dir", required=True, type=str)
    p.add_argument("-p", "--data_prefix", default="", type=str)
    p.add_argument("-o", "--output_dir", required=True, type=str)
    p.add_argument("-w", "--weight_file", required=True, type=str)
    p.add_argument("-f", "--save_format", default="preds", type=str,
                   help="preds or logits")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _, _, forward = load_gnn_from_checkpoint(
        os.path.expanduser(args.weight_file), device=args.device)
    output_dir = os.path.expanduser(args.output_dir)
    os.makedirs(output_dir, exist_ok=True)
    dataset = ImageGraphDataset(os.path.expanduser(args.data_dir),
                                args.data_prefix, read_image=False,
                                read_graph=True, read_label=False)
    with precision_scope(os.environ.get("GTS_PALLAS_PRECISION", "exact")):
        save_predictions(forward, dataset, output_dir, args.save_format)
    print(f"Finished saving {args.save_format} generated by {args.weight_file} "
          f"in folder {output_dir}")


if __name__ == "__main__":
    main()
