"""Model factory (counterpart of gnn_tumor_seg_tpu/models/factory.py).

GSpool, GSmean and GSgcn (GraphSAGE with the pool, mean and gcn aggregator)
are ported; GAT waits for its kernels (ROADMAP.md).
"""

from __future__ import annotations

import torch

from .sage import GraphSage

__all__ = ["init_graph_net", "GRAPH_MODEL_TYPES", "SAGE_AGGREGATORS"]

GRAPH_MODEL_TYPES = ("GSpool", "GSmean", "GSgcn")
SAGE_AGGREGATORS = {"GSpool": "pool", "GSmean": "mean", "GSgcn": "gcn"}


def init_graph_net(model_type: str, hp,
                   generator: torch.Generator | None = None) -> GraphSage:
    """hp needs in_feats, out_classes, layer_sizes and feature_dropout.
    Returns a GraphSage on the CPU with parameters drawn from `generator`;
    move it with `.to(device)`."""
    if model_type not in SAGE_AGGREGATORS:
        raise NotImplementedError(
            f"model type {model_type!r} is not ported yet (ROADMAP.md, "
            f"modules to port); ported: {GRAPH_MODEL_TYPES}")
    return GraphSage(
        in_feats=hp.in_feats,
        layer_sizes=hp.layer_sizes,
        n_classes=hp.out_classes,
        dropout=getattr(hp, "feature_dropout", 0) or 0,
        generator=generator,
        aggregator=SAGE_AGGREGATORS[model_type],
    )
