"""CLI: interactive volume viewer with predictions overlaid (j/k to scroll).

Argument contract mirrors `visualization/plot_pred_volume.py:12-38`. It is the
counterpart of gnn_tumor_seg_tpu/cli/plot_pred_volume.py, with the same flags,
and runs on the host, as that CLI does (no --device). It needs matplotlib,
which is imported only inside `main`.
Run: python -m gnn_tumor_seg_tpu_torch.cli.plot_pred_volume -d <raw> -s <preds> -i <id> [-l]
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--data_dir", required=True, type=str)
    p.add_argument("-s", "--seg_dir", required=True, type=str)
    p.add_argument("-i", "--mri_id", required=True, type=str)
    p.add_argument("-l", "--plot_gt", action="store_true")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..viz.helpers import load_plotting_data
    from ..viz.volume_viewer import multi_slice_viewer

    flair, t1ce, preds, gt = load_plotting_data(
        os.path.expanduser(args.data_dir), os.path.expanduser(args.seg_dir),
        args.mri_id, read_labels=args.plot_gt,
    )
    panels = [
        {"arr": flair, "cmap": "gray", "stride": 1, "title": "FLAIR"},
        {"arr": t1ce, "cmap": "gray", "stride": 1, "title": "T1CE"},
        {"arr": preds, "cmap": "gray", "stride": 1, "title": "Predictions"},
    ]
    if args.plot_gt:
        panels.append({"arr": gt, "cmap": "gray", "stride": 1, "title": "Ground Truth"})
    multi_slice_viewer(panels)


if __name__ == "__main__":
    main()
