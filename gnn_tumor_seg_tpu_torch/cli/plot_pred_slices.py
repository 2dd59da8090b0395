"""CLI: slice-triptych plots of predictions (and optionally GT) over raw MRI.

Argument contract mirrors `visualization/plot_pred_slices.py:11-68`. It is the
counterpart of gnn_tumor_seg_tpu/cli/plot_pred_slices.py, with the same flags,
and runs on the host, as that CLI does (no --device). It needs matplotlib,
which is imported only inside `main`.
Run: python -m gnn_tumor_seg_tpu_torch.cli.plot_pred_slices -d <raw> -s <preds> -i <id> [-l]
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--data_dir", required=True, type=str)
    p.add_argument("-s", "--seg_dir", required=True, type=str)
    p.add_argument("-i", "--mri_id", required=True, type=str)
    p.add_argument("-cp", "--coronal", default=100, type=int)
    p.add_argument("-sp", "--sagittal", default=100, type=int)
    p.add_argument("-hp", "--horizontal", default=100, type=int)
    p.add_argument("-l", "--plot_gt", action="store_true")
    p.add_argument("--save", default=None, type=str,
                   help="save the figure instead of showing it")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import matplotlib

    if args.save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..viz.helpers import load_plotting_data

    mod1, mod2, preds, gt = load_plotting_data(
        os.path.expanduser(args.data_dir), os.path.expanduser(args.seg_dir),
        args.mri_id, read_labels=args.plot_gt,
    )
    hs, cs, ss = args.horizontal, args.coronal, args.sagittal
    panels = [mod1, mod2, preds] + ([gt] if args.plot_gt else [])
    nrows = len(panels)
    fig, axs = plt.subplots(nrows, 3, figsize=(12, 2 * nrows))
    for r, vol in enumerate(panels):
        for c, sl in enumerate((vol[:, :, hs], vol[:, cs, :], vol[ss, :, :])):
            ax = axs[r, c] if nrows > 1 else axs[c]
            ax.imshow(sl, cmap="gray")
            ax.axis("off")
    fig.tight_layout(pad=0)
    if args.save:
        fig.savefig(args.save, dpi=120)
        print(f"Saved {args.save}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
