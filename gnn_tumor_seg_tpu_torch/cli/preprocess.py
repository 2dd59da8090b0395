"""CLI: preprocess a BraTS-style dataset into graph samples (counterpart of
gnn_tumor_seg_tpu/cli/preprocess.py).

Argument contract mirrors `scripts/preprocess_dataset.py:172-187`, as the JAX
package's CLI does. The host path needs no card; `--slic_impl tpu` (SLIC on
the card) and `--prep_impl device` (normalization, smoothing and SLIC as one
chain on the card, ops/slic_device.py) run on --device, the card unless
asked for the CPU.
Run: python -m gnn_tumor_seg_tpu_torch.cli.preprocess -d <raw> -o <out>
     [-l _seg.nii.gz] [--weighted] [--prep_impl device] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

from ..data.preprocess import DEFAULT_MODALITY_EXTS, DataPreprocessor
from .common import resolve_slic_fn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--data_dir", required=True, type=str,
                   help="path to the directory where raw MRI data is stored")
    p.add_argument("-n", "--num_nodes", default=15000, type=int,
                   help="How many supervoxels to segment brain into")
    p.add_argument("-k", "--num_neighbors", default=10, type=int,
                   help="Neighbors per node in the kNN adjacency; 0 = adjacency "
                        "from contiguous supervoxels (with self-loops)")
    p.add_argument("-b", "--boxiness", default=0.5, type=float,
                   help="SLIC compactness (recommended range [0.1, 1.0])")
    p.add_argument("-o", "--output_dir", required=True, type=str,
                   help="Directory to save preprocessed samples to")
    p.add_argument("-m", "--modality_extensions", nargs="+",
                   default=DEFAULT_MODALITY_EXTS,
                   help="File extensions of the desired modalities, in order")
    p.add_argument("-l", "--label_extension", default=None, type=str,
                   help="Label file extension; omit for unlabelled (test) data")
    p.add_argument("-p", "--data_prefix", default="", type=str,
                   help="Prefix all data folders share, e.g. BraTS2021")
    p.add_argument("--save_json", action="store_true",
                   help="Also write reference-compatible networkx node-link JSON")
    p.add_argument("--threads", default=6, type=int)
    p.add_argument("--weighted", action="store_true",
                   help="attach Gaussian intensity-similarity edge weights "
                        "(the reference's weighted-adjacency option, "
                        "graphgen.py:142-150)")
    p.add_argument("--slic_impl", default="auto",
                   choices=("auto", "native", "numpy", "tpu"),
                   help="supervoxelization backend: host canonical "
                        "(auto/native/numpy) or 'tpu' (the JAX package's "
                        "name), smoothing and assignment on the card. For "
                        "bulk preprocessing see also --prep_impl")
    p.add_argument("--prep_impl", default="auto",
                   choices=("auto", "host", "device"),
                   help="'device' runs normalize+standardize+smooth+SLIC as "
                        "one chain on the card per sample, with the host's "
                        "stats/kNN/writes overlapping across the thread "
                        "pool; 'auto' = device when --slic_impl tpu")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where --slic_impl tpu and --prep_impl device run; "
                        "'cpu' runs them with PyTorch on the CPU")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    prep_impl = args.prep_impl
    if prep_impl == "auto":
        prep_impl = "device" if args.slic_impl == "tpu" else "host"
    pre = DataPreprocessor(
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        num_nodes=args.num_nodes,
        num_neighbors=args.num_neighbors,
        boxiness=args.boxiness,
        mri_prefix=args.data_prefix,
        modality_extensions=args.modality_extensions,
        label_extension=args.label_extension,
        save_json=args.save_json,
        n_threads=args.threads,
        weighted=args.weighted,
        slic_fn=resolve_slic_fn(args.slic_impl, device=args.device),
        prep_impl=prep_impl,
        device=args.device,
    )
    pre.run()
    print(f"Finished preprocessing data from {args.data_dir}.")


if __name__ == "__main__":
    main()
