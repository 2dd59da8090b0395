"""CLI: convert reference torch state_dicts (.pt) into the port's checkpoints
(counterpart of gnn_tumor_seg_tpu/cli/import_torch_weights.py, the same
flags and the same checkpoint format, train/checkpoint.py).

The reference ships `weights/provided_cnn_weights.pt` whose conv shapes are
(16,9,5,5,5)/(5,16,5,5,5) — 9 input channels / 5 output classes — which the
reference's own loader cannot load (it hardcodes 8-in/4-out,
`scripts/generate_joint_predictions.py:31-38`). Here, as in the JAX
package, the architecture is read off the state_dict's shapes and embedded
into the checkpoint, so an imported CNN runs directly in
`cli.generate_joint_predictions`.

GNN state_dicts import in the layouts the reference's training would
produce (DGL >= 0.8 SAGEConv / GATConv parameter names under a `layers.{i}.`
ModuleList prefix, `model/networks.py:20-66`). The conversion only
transposes: torch Linear weights [out, in] become [in, out], Conv3d weights
OIDHW become DHWIO. It is host work: the state_dict is loaded on the CPU.

Run: python -m gnn_tumor_seg_tpu_torch.cli.import_torch_weights \\
         -i provided_cnn_weights.pt -o cnn.ckpt [-t CNN|GSpool|GSmean|GSgcn|GAT] \\
         [--gat_residuals 0,1,...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import HyperParams
from ..convert import cnn_params_from_jax, gat_params_from_jax, gnn_params_from_jax
from ..train.checkpoint import save_checkpoint

__all__ = ["convert_cnn_state_dict", "convert_sage_state_dict",
           "convert_gat_state_dict", "import_torch_weights", "main"]


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      dtype=np.float32)


def convert_cnn_state_dict(sd: dict):
    """Torch CnnRefinementNet state_dict -> (params, HyperParams), params in
    the JAX package's layout ({"conv0": {"w", "b"}, "conv1": ...}, DHWIO).

    Torch Conv3d weights are OIDHW (Cout, Cin, k, k, k) and transpose to
    (k, k, k, Cin, Cout). Architecture (in_feats / hidden / out_classes) is
    read off the shapes, not assumed."""
    w0 = _np(sd["conv_layers.0.weight"])
    b0 = _np(sd["conv_layers.0.bias"])
    w1 = _np(sd["conv_layers.1.weight"])
    b1 = _np(sd["conv_layers.1.bias"])
    hidden, in_feats = w0.shape[0], w0.shape[1]
    out_classes = w1.shape[0]
    if w1.shape[1] != hidden:
        raise ValueError(f"conv1 expects {w1.shape[1]} channels, conv0 "
                         f"produces {hidden}")
    params = {
        "conv0": {"w": w0.transpose(2, 3, 4, 1, 0), "b": b0},
        "conv1": {"w": w1.transpose(2, 3, 4, 1, 0), "b": b1},
    }
    hp = HyperParams(in_feats=in_feats, out_classes=out_classes,
                     layer_sizes=[hidden], batch_size=1)
    return params, hp


def _layer_indices(sd: dict) -> list[int]:
    idx = sorted({int(k.split(".")[1]) for k in sd if k.startswith("layers.")})
    if not idx:
        raise ValueError("no 'layers.{i}.*' keys found — not a reference GNN "
                         "state_dict")
    return idx


def convert_sage_state_dict(sd: dict, aggregator: str):
    """DGL SAGEConv stack state_dict -> (params, HyperParams, model_type).

    DGL >= 0.8 names per layer: fc_neigh.weight, bias, fc_self.weight
    (mean/pool), fc_pool.weight/.bias (pool). Linear weights are [out, in];
    the port stores [in, out] (models/sage.py) -> transpose."""
    params, widths = [], []
    for i in _layer_indices(sd):
        pre = f"layers.{i}."
        lp = {"w_neigh": _np(sd[pre + "fc_neigh.weight"]).T,
              "bias": _np(sd[pre + "bias"])}
        if aggregator != "gcn":
            lp["w_self"] = _np(sd[pre + "fc_self.weight"]).T
        if aggregator == "pool":
            lp["w_pool"] = _np(sd[pre + "fc_pool.weight"]).T
            lp["b_pool"] = _np(sd[pre + "fc_pool.bias"])
        params.append(lp)
        widths.append(lp["w_neigh"].shape[1])
    in_feats = params[0]["w_neigh"].shape[0]
    hp = HyperParams(in_feats=in_feats, out_classes=widths[-1],
                     layer_sizes=widths[:-1])
    model_type = {"mean": "GSmean", "gcn": "GSgcn", "pool": "GSpool"}[aggregator]
    return params, hp, model_type


def convert_gat_state_dict(sd: dict, residuals: list[bool] | None = None):
    """DGL GATConv stack state_dict -> (params, HyperParams, "GAT").

    DGL names per layer: fc.weight [H*F, in], attn_l/attn_r [1, H, F],
    bias [H*F], res_fc.weight when a projected residual exists. An identity
    residual (dims match) leaves no parameters in the state_dict, so it
    cannot be inferred: pass `residuals` for layers that used one."""
    params, heads, widths, inferred_res = [], [], [], []
    for i in _layer_indices(sd):
        pre = f"layers.{i}."
        al = _np(sd[pre + "attn_l"])           # [1, H, F]
        h, f = al.shape[-2], al.shape[-1]
        lp = {"w": _np(sd[pre + "fc.weight"]).T,
              "attn_l": al.reshape(h, f),
              "attn_r": _np(sd[pre + "attn_r"]).reshape(h, f),
              "bias": _np(sd[pre + "bias"]).reshape(-1)}
        has_res = (pre + "res_fc.weight") in sd
        if has_res:
            lp["w_res"] = _np(sd[pre + "res_fc.weight"]).T
        params.append(lp)
        heads.append(h)
        widths.append(f)
        inferred_res.append(has_res)
    if residuals is None:
        residuals = inferred_res
    residuals = [bool(r) for r in residuals]
    in_feats = params[0]["w"].shape[0]
    hp = HyperParams(in_feats=in_feats, out_classes=widths[-1],
                     layer_sizes=widths[:-1], gat_heads=heads[:-1],
                     gat_residuals=residuals[:-1])
    return params, hp, "GAT"


def import_torch_weights(input_pt: str, output_ckpt: str,
                         model_type: str = "CNN",
                         gat_residuals: list[bool] | None = None) -> HyperParams:
    """Load a torch .pt state_dict and write a port checkpoint (which the
    JAX package loads too). Returns the inferred HyperParams."""
    import torch

    sd = torch.load(input_pt, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):  # a full module was pickled, not a state_dict
        sd = sd.state_dict()
    if model_type == "CNN":
        params, hp = convert_cnn_state_dict(sd)
        model = cnn_params_from_jax(params)
    elif model_type in ("GSpool", "GSmean", "GSgcn"):
        agg = {"GSpool": "pool", "GSmean": "mean", "GSgcn": "gcn"}[model_type]
        params, hp, model_type = convert_sage_state_dict(sd, agg)
        model = gnn_params_from_jax(params)
    elif model_type == "GAT":
        params, hp, model_type = convert_gat_state_dict(sd, gat_residuals)
        model = gat_params_from_jax(params, hp.gat_residuals)
    else:
        raise ValueError(f"unknown model type {model_type!r}")
    save_checkpoint(output_ckpt, model, model_type, hp,
                    extra={"imported_from": os.path.basename(input_pt)})
    return hp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", "--input", required=True, type=str,
                   help="torch .pt state_dict")
    p.add_argument("-o", "--output", required=True, type=str,
                   help="output .ckpt path")
    p.add_argument("-t", "--model_type", default="CNN",
                   choices=["CNN", "GSpool", "GSmean", "GSgcn", "GAT"])
    p.add_argument("--gat_residuals", default=None, type=str,
                   help="comma list of 0/1 per layer (identity residuals are "
                        "not inferrable from a state_dict)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    residuals = None
    if args.gat_residuals:
        residuals = [x.strip() in ("1", "true", "True")
                     for x in args.gat_residuals.split(",")]
    hp = import_torch_weights(os.path.expanduser(args.input),
                              os.path.expanduser(args.output),
                              args.model_type, residuals)
    print(f"Imported {args.input} -> {args.output} "
          f"({args.model_type}, in={hp.in_feats}, out={hp.out_classes}, "
          f"layers={hp.layer_sizes})")


if __name__ == "__main__":
    main()
