"""Model factory (counterpart of gnn_tumor_seg_tpu/models/factory.py).

GSpool is ported; GSgcn, GSmean and GAT wait for their kernels (ROADMAP.md).
"""

from __future__ import annotations

import torch

from .sage import GraphSage

__all__ = ["init_graph_net", "GRAPH_MODEL_TYPES"]

GRAPH_MODEL_TYPES = ("GSpool",)


def init_graph_net(model_type: str, hp,
                   generator: torch.Generator | None = None) -> GraphSage:
    """hp needs in_feats, out_classes, layer_sizes and feature_dropout.
    Returns a GraphSage on the CPU with parameters drawn from `generator`;
    move it with `.to(device)`."""
    if model_type != "GSpool":
        raise NotImplementedError(
            f"model type {model_type!r} is not ported yet (ROADMAP.md, "
            f"modules to port); ported: {GRAPH_MODEL_TYPES}")
    return GraphSage(
        in_feats=hp.in_feats,
        layer_sizes=hp.layer_sizes,
        n_classes=hp.out_classes,
        dropout=getattr(hp, "feature_dropout", 0) or 0,
        generator=generator,
    )
