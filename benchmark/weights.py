"""Seeded weights of a configuration, drawn on the device in one call.

Both sides get these: the program has them copied into its models (in its
checkpoint leaf order, which `param_specs` follows), the reference reads
them by name. The bounds are the initializers' of the published models
(DGL's SAGEConv and GATConv: Xavier uniform with gain sqrt(2); torch's
Conv3d: Kaiming uniform with a = sqrt(5) and its uniform bias); the GNN
biases, zero at initialization, are drawn within +-0.1 so that the check
covers them (configs' `assumed`).
"""

from __future__ import annotations

import math

import torch

GNN_BIAS_BOUND = 0.1


def _xavier(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out))


def sage_specs(dims: list[int]) -> list[tuple[str, tuple, float]]:
    """GraphSAGE-pool: per layer b_pool, bias, w_neigh, w_pool, w_self."""
    specs = []
    for i, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        specs += [(f"l{i}.b_pool", (fi,), GNN_BIAS_BOUND),
                  (f"l{i}.bias", (fo,), GNN_BIAS_BOUND),
                  (f"l{i}.w_neigh", (fi, fo), _xavier(fi, fo)),
                  (f"l{i}.w_pool", (fi, fi), _xavier(fi, fi)),
                  (f"l{i}.w_self", (fi, fo), _xavier(fi, fo))]
    return specs


def gat_layers(in_feats: int, layer_sizes, heads, residuals,
               out_classes: int) -> list[tuple[int, int, int, bool]]:
    """(in, out, heads, residual) of each GAT layer: the input layer has no
    residual, a hidden layer reads the previous width times its heads, the
    output layer has one head."""
    layers = [(in_feats, layer_sizes[0], heads[0], False)]
    for i in range(1, len(layer_sizes)):
        layers.append((layer_sizes[i - 1] * heads[i - 1], layer_sizes[i],
                       heads[i], bool(residuals[i])))
    layers.append((layer_sizes[-1] * heads[len(layer_sizes) - 1], out_classes,
                   1, False))
    return layers


def gat_specs(layers) -> list[tuple[str, tuple, float]]:
    """GAT: per layer attn_l, attn_r, bias, w and, on a residual layer whose
    input width is not heads x out, w_res."""
    specs = []
    for i, (fi, fo, h, res) in enumerate(layers):
        hf = h * fo
        specs += [(f"l{i}.attn_l", (h, fo), _xavier(h, fo)),
                  (f"l{i}.attn_r", (h, fo), _xavier(h, fo)),
                  (f"l{i}.bias", (hf,), GNN_BIAS_BOUND),
                  (f"l{i}.w", (fi, hf), _xavier(fi, hf))]
        if res and fi != hf:
            specs.append((f"l{i}.w_res", (fi, hf), _xavier(fi, hf)))
    return specs


def cnn_specs(in_feats: int, hidden: int, out_classes: int,
              k: int = 5) -> list[tuple[str, tuple, float]]:
    """The refinement CNN in the program's leaf order: b0, w0, b1, w1
    (weights OIDHW)."""
    specs = []
    for i, (ci, co) in enumerate(((in_feats, hidden), (hidden, out_classes))):
        fan_in = ci * k ** 3
        specs += [(f"b{i}", (co,), 1.0 / math.sqrt(fan_in)),
                  (f"w{i}", (co, ci, k, k, k),
                   math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in))]
    return specs


def model_specs(config: dict) -> list[tuple[str, tuple, float]]:
    m = config["model"]
    if m == "GSpool":
        return sage_specs([config["in_feats"], *config["layer_sizes"],
                           config["out_classes"]])
    if m == "GAT":
        return gat_specs(gat_layers(config["in_feats"], config["layer_sizes"],
                                    config["gat_heads"], config["gat_residuals"],
                                    config["out_classes"]))
    raise ValueError(f"no weights for model {m!r}")


def draw(specs, gen: torch.Generator) -> dict[str, torch.Tensor]:
    """Every tensor of `specs` uniform within its bound, float32 on gen's
    device, from one draw."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.rand(sum(sizes), generator=gen, device=gen.device) * 2 - 1
    out, start = {}, 0
    for (name, shape, bound), n in zip(specs, sizes):
        out[name] = (flat[start:start + n] * bound).reshape(shape)
        start += n
    return out


def load_into(params: list[torch.nn.Parameter], weights: dict, specs) -> None:
    """Copy the drawn weights into a program model's parameters, given in
    the program's checkpoint leaf order (the order of `specs`)."""
    if len(params) != len(specs):
        raise ValueError(f"model has {len(params)} parameters, the "
                         f"configuration {len(specs)}")
    with torch.no_grad():
        for p, (name, shape, _) in zip(params, specs):
            if tuple(p.shape) != tuple(shape):
                raise ValueError(f"{name}: model parameter {tuple(p.shape)}, "
                                 f"configuration {shape}")
            p.copy_(weights[name].to(p.device))
