"""Analytic FLOPs of the models, from their widths and the real nodes,
edges and voxels a pass covers (padding excluded). A multiply-add counts 2.
A training step counts the forward three times (activation and weight
gradients), except the first layer's, whose input needs no gradient (two).
"""

from __future__ import annotations

from .models import load


def sage_pool_layer(n: int, e: int, fi: int, fo: int) -> float:
    """models/GSpool.py's, under the name its readers import."""
    return load("GSpool").sage_pool_layer(n, e, fi, fo)


def gat_layer(n: int, e: int, fi: int, fo: int, heads: int, w_res: bool) -> float:
    """models/GAT.py's, under the name its readers import."""
    return load("GAT").gat_layer(n, e, fi, fo, heads, w_res)


def gnn_layers(config: dict, n: int, e: int) -> list[float]:
    """Forward FLOPs of each layer of the configuration's GNN over n real
    nodes and e real (directed) edges: models/<model>.py's layer_flops."""
    return load(config["model"]).layer_flops(config, n, e)


def gnn_forward(config: dict, n: int, e: int) -> float:
    return sum(gnn_layers(config, n, e))


def gnn_train_step(config: dict, n: int, e: int) -> float:
    per_layer = gnn_layers(config, n, e)
    return 2.0 * per_layer[0] + 3.0 * sum(per_layer[1:])


def cnn_forward(cnn: dict, voxels: int) -> float:
    """The refinement CNN over `voxels` output voxels (its padded input
    crop): two k^3 convolutions."""
    k3 = cnn["kernel"] ** 3
    c0, c1, c2 = cnn["in_feats"], cnn["layer_sizes"][0], cnn["out_classes"]
    return 2.0 * voxels * k3 * (c0 * c1 + c1 * c2)
