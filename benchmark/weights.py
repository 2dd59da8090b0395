"""Seeded weights of a configuration, drawn on the device in one call.

Both sides get these: the program has them copied into its models (in its
checkpoint leaf order, which `model_specs` follows), the reference reads
them by name. Each model's specs are in models/<model>.py. The bounds are
the initializers' of the published models (DGL's SAGEConv and GATConv:
Xavier uniform with gain sqrt(2); torch's Conv3d: Kaiming uniform with a =
sqrt(5) and its uniform bias); the GNN biases, zero at initialization, are
drawn within +-0.1 so that the check covers them (configs' `assumed`).
"""

from __future__ import annotations

import math

import torch

GNN_BIAS_BOUND = 0.1


def xavier(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out))


def gat_layers(in_feats: int, layer_sizes, heads, residuals,
               out_classes: int) -> list[tuple[int, int, int, bool]]:
    """models/GAT.py's gat_layers, under the name its readers import."""
    from .models import load

    return load("GAT").gat_layers(in_feats, layer_sizes, heads, residuals,
                                  out_classes)


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
    """The configuration's model's weights: models/<model>.py's specs."""
    from .models import load

    return load(config["model"]).specs(config)


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
