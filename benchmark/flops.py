"""Analytic FLOPs of the models, from their widths and the real nodes,
edges and voxels a pass covers (padding excluded). A multiply-add counts 2.
A training step counts the forward three times (activation and weight
gradients), except the first layer's, whose input needs no gradient (two).
"""

from __future__ import annotations

from .weights import gat_layers


def sage_pool_layer(n: int, e: int, fi: int, fo: int) -> float:
    return 2.0 * n * fi * fi + 4.0 * n * fi * fo + 1.0 * e * fi


def gat_layer(n: int, e: int, fi: int, fo: int, heads: int, w_res: bool) -> float:
    hf = heads * fo
    dense = 2.0 * n * fi * hf * (2 if w_res else 1) + 4.0 * n * hf
    # per edge and head: score, LeakyReLU, exp, normalize; weighted sum of z
    return dense + 4.0 * e * heads + 2.0 * e * hf


def gnn_layers(config: dict, n: int, e: int) -> list[float]:
    """Forward FLOPs of each layer of the configuration's GNN over n real
    nodes and e real (directed) edges."""
    if config["model"] == "GSpool":
        dims = [config["in_feats"], *config["layer_sizes"], config["out_classes"]]
        return [sage_pool_layer(n, e, a, b) for a, b in zip(dims[:-1], dims[1:])]
    if config["model"] == "GAT":
        layers = gat_layers(config["in_feats"], config["layer_sizes"],
                            config["gat_heads"], config["gat_residuals"],
                            config["out_classes"])
        return [gat_layer(n, e, fi, fo, h, res and fi != h * fo)
                for fi, fo, h, res in layers]
    raise ValueError(f"no FLOP count for model {config['model']!r}")


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
