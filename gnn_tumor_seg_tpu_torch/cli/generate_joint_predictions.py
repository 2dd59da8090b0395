"""CLI: joint GNN -> refinement-CNN inference over a preprocessed dataset, on
one device (counterpart of gnn_tumor_seg_tpu/cli/generate_joint_predictions.py).

Argument contract of `scripts/generate_joint_predictions.py:79-103` and of
the JAX package's CLI (without the reference's undefined args.save_format),
plus --device. Both models are rebuilt from their checkpoints' embedded
configs. Each sample goes through cli/common.predict_one_sample, the
host-materialized chain the JAX CLI runs: GNN forward (the Hopper kernels
on the card), voxel logits, tumor crop, CNN, uncrop, BraTS labels, written
as `<id>.nii.gz`.

  python -m gnn_tumor_seg_tpu_torch.cli.generate_joint_predictions -d <processed> \\
      -o <preds> -g <gnn.ckpt> -c <cnn.ckpt> [--precision exact|fast] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

from ..data import nifti
from ..data.dataset import ImageGraphDataset
from ..data.image import swap_labels_to_brats, uncrop_to_brats_size
from ..ops.precision import precision_scope
from .common import (load_cnn_from_checkpoint, load_gnn_from_checkpoint,
                     predict_one_sample)

__all__ = ["main", "build_parser", "save_predictions"]


def save_predictions(gnn_forward, cnn_forward, dataset, output_dir):
    for i, mri_id in enumerate(dataset.ids):
        try:
            sv = dataset.get_supervoxel_partitioning(mri_id)
            crop = dataset.get_crop(mri_id)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"Couldnt predict {mri_id} because couldn't read a required file: {e}"
            )
        graph = dataset.get_graph(i)
        img = dataset.get_image(mri_id)
        pred = predict_one_sample(gnn_forward, cnn_forward, graph, img, sv)
        pred = uncrop_to_brats_size(crop, pred, shape=dataset.get_orig_shape(mri_id))
        pred = swap_labels_to_brats(pred)
        nifti.save_as_nifti(pred, os.path.join(output_dir, f"{mri_id}.nii.gz"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--data_dir", required=True, type=str)
    p.add_argument("-p", "--data_prefix", default="", type=str)
    p.add_argument("-o", "--output_dir", required=True, type=str)
    p.add_argument("-c", "--cnn_weights", required=True, type=str)
    p.add_argument("-g", "--gnn_weights", required=True, type=str)
    p.add_argument("--precision", default="fast", choices=("exact", "fast"),
                   help="'fast' runs the GNN and CNN with bf16 activations "
                        "(the CNN training default); 'exact' in float32 "
                        "with TF32 off")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _, _, gnn_forward = load_gnn_from_checkpoint(
        os.path.expanduser(args.gnn_weights), device=args.device)
    _, _, cnn_forward = load_cnn_from_checkpoint(
        os.path.expanduser(args.cnn_weights), device=args.device)
    output_dir = os.path.expanduser(args.output_dir)
    os.makedirs(output_dir, exist_ok=True)
    dataset = ImageGraphDataset(os.path.expanduser(args.data_dir),
                                args.data_prefix, read_image=True,
                                read_graph=True, read_label=False)
    with precision_scope(args.precision):
        save_predictions(gnn_forward, cnn_forward, dataset, output_dir)
    print(f"Finished saving predictions generated by {args.gnn_weights} and "
          f"{args.cnn_weights} in folder {output_dir}")


if __name__ == "__main__":
    main()
