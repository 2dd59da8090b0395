"""Model factory (counterpart of gnn_tumor_seg_tpu/models/factory.py).

GSpool, GSmean and GSgcn (GraphSAGE with the pool, mean and gcn aggregator),
GAT (heads and residuals from the hyperparameters) and GPS (GraphGPS, the
port's own model: no JAX counterpart; heads and head depth from the
hyperparameters).
"""

from __future__ import annotations

import torch

from .gat import GAT
from .gps import GPS
from .sage import GraphSage

__all__ = ["init_graph_net", "GRAPH_MODEL_TYPES", "SAGE_AGGREGATORS"]

GRAPH_MODEL_TYPES = ("GSpool", "GSmean", "GSgcn", "GAT", "GPS")
SAGE_AGGREGATORS = {"GSpool": "pool", "GSmean": "mean", "GSgcn": "gcn"}


def init_graph_net(model_type: str, hp,
                   generator: torch.Generator | None = None
                   ) -> GraphSage | GAT | GPS:
    """hp needs in_feats, out_classes, layer_sizes and feature_dropout, for
    GAT gat_heads and gat_residuals, and for GPS gps_heads and
    gps_post_layers. Returns the model on the CPU with
    parameters drawn from `generator`; move it with `.to(device)`."""
    dropout = getattr(hp, "feature_dropout", 0) or 0
    if model_type == "GAT":
        if hp.gat_heads is None or hp.gat_residuals is None:
            raise ValueError("GAT needs gat_heads and gat_residuals in its "
                             "hyperparameters (hardcoded_hyperparameters('GAT') "
                             "sets them)")
        return GAT(in_feats=hp.in_feats, layer_sizes=hp.layer_sizes,
                   n_classes=hp.out_classes, heads=hp.gat_heads,
                   residuals=hp.gat_residuals, feat_drop=dropout,
                   generator=generator)
    if model_type == "GPS":
        if hp.gps_heads is None or hp.gps_post_layers is None:
            raise ValueError("GPS needs gps_heads and gps_post_layers in its "
                             "hyperparameters (hardcoded_hyperparameters('GPS') "
                             "sets them)")
        return GPS(in_feats=hp.in_feats, layer_sizes=hp.layer_sizes,
                   n_classes=hp.out_classes, heads=hp.gps_heads,
                   post_layers=hp.gps_post_layers, dropout=dropout,
                   generator=generator)
    if model_type not in SAGE_AGGREGATORS:
        raise NotImplementedError(
            f"unknown or unported model type {model_type!r}; expected one of "
            f"{GRAPH_MODEL_TYPES}")
    return GraphSage(
        in_feats=hp.in_feats,
        layer_sizes=hp.layer_sizes,
        n_classes=hp.out_classes,
        dropout=dropout,
        generator=generator,
        aggregator=SAGE_AGGREGATORS[model_type],
    )
