"""Parameter initializers (counterpart of gnn_tumor_seg_tpu/models/initializers.py).

Same bounds as the JAX package: DGL's SAGEConv/GATConv use xavier_uniform with
gain sqrt(2); torch's Conv3d uses kaiming_uniform(a=sqrt(5)) with a uniform
bias. Values are drawn from a torch.Generator, so they differ from the JAX
package's for the same seed; the distributions match.
"""

from __future__ import annotations

import math

import torch

__all__ = ["xavier_uniform", "kaiming_uniform_conv", "conv_bias_uniform"]


def _uniform(shape, bound: float, generator: torch.Generator | None):
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)


def xavier_uniform(shape, generator: torch.Generator | None = None,
                   gain: float = math.sqrt(2.0)) -> torch.Tensor:
    """Xavier/Glorot uniform for a [fan_in, fan_out] weight matrix."""
    fan_in, fan_out = shape
    return _uniform(shape, gain * math.sqrt(6.0 / (fan_in + fan_out)), generator)


def kaiming_uniform_conv(shape, generator: torch.Generator | None = None
                         ) -> torch.Tensor:
    """torch-default conv weight init: kaiming_uniform(a=sqrt(5)).

    shape: [kd, kh, kw, in_ch, out_ch] (DHWIO, the JAX package's layout)."""
    fan_in = shape[-2] * math.prod(shape[:-2])
    gain = math.sqrt(2.0 / (1.0 + 5.0))  # leaky_relu gain with a=sqrt(5)
    return _uniform(shape, gain * math.sqrt(3.0 / fan_in), generator)


def conv_bias_uniform(fan_in: int, out_ch: int,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    return _uniform((out_ch,), 1.0 / math.sqrt(fan_in), generator)
