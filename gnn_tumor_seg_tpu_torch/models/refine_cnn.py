"""3D refinement CNN (counterpart of gnn_tumor_seg_tpu/models/refine_cnn.py).

Conv3d(in -> layer_sizes[0], k=5, replicate pad 2) -> ReLU ->
Conv3d(layer_sizes[0] -> out_classes, same geometry)
(`model/networks.py:83-93`). The public layout is NDHWC, as in the JAX
package; the module permutes to PyTorch's NCDHW inside. The convolutions go
through torch.nn.functional.conv3d, as the JAX package leaves them to XLA.

Under precision mode "fast" the convolutions run in bf16 (parameters cast at
use) and only the head logits return to float32. Under "exact" they run in
float32 with cuDNN's TF32 switched off (ops/precision.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import compute_dtype
from .initializers import conv_bias_uniform, kaiming_uniform_conv

__all__ = ["CnnRefinementNet"]

_K = 5
_PAD = 2


def _replicate_conv3d(x, w, b):
    """x [B, C, D, H, W]; w [Cout, Cin, 5, 5, 5]: replicate-pad 2, VALID conv."""
    x = F.pad(x, (_PAD,) * 6, mode="replicate")
    return F.conv3d(x, w, b)


class CnnRefinementNet(nn.Module):
    def __init__(self, in_feats: int, out_classes: int,
                 layer_sizes: Sequence[int],
                 generator: torch.Generator | None = None):
        super().__init__()
        self.in_feats = in_feats
        self.out_classes = out_classes
        self.layer_sizes = list(layer_sizes)
        if len(self.layer_sizes) != 1:
            raise ValueError("the reference architecture is 2 conv layers "
                             f"(one hidden width), got {self.layer_sizes}")
        c0, c1 = in_feats, self.layer_sizes[0]
        # drawn in the JAX package's DHWIO layout, stored as torch's OIDHW
        dhwio_to_oidhw = (4, 3, 0, 1, 2)
        self.w0 = nn.Parameter(kaiming_uniform_conv(
            (_K, _K, _K, c0, c1), generator).permute(dhwio_to_oidhw).contiguous())
        self.b0 = nn.Parameter(conv_bias_uniform(c0 * _K ** 3, c1, generator))
        self.w1 = nn.Parameter(kaiming_uniform_conv(
            (_K, _K, _K, c1, out_classes), generator
        ).permute(dhwio_to_oidhw).contiguous())
        self.b1 = nn.Parameter(conv_bias_uniform(c1 * _K ** 3, out_classes,
                                                 generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, D, H, W, in_feats] -> float32 logits [B, D, H, W, out_classes]."""
        cd = compute_dtype()
        x = x.to(cd).permute(0, 4, 1, 2, 3)
        h = torch.relu(_replicate_conv3d(x, self.w0.to(cd), self.b0.to(cd)))
        out = _replicate_conv3d(h, self.w1.to(cd), self.b1.to(cd))
        return out.permute(0, 2, 3, 4, 1).float()
