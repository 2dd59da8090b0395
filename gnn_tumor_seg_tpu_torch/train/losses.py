"""Losses (counterpart of gnn_tumor_seg_tpu/train/losses.py): class-weighted
softmax cross-entropy with torch-parity normalization.

torch.nn.CrossEntropyLoss(weight=w) (used at `model/gnn_model.py:30`)
computes sum_i w[y_i] * nll_i / sum_i w[y_i], a weighted mean. Padded
elements (mask 0 or label < 0) are left out of both sums, so bucket padding
never moves the loss. Written with masks, not boolean indexing, so the loss
makes no host round trip on the card.
"""

from __future__ import annotations

import torch

__all__ = ["weighted_cross_entropy", "weighted_cross_entropy_per_graph",
           "weighted_nll_terms"]


def weighted_nll_terms(logits, labels, class_weights, mask=None):
    """(w * nll, w) per element: the weighted mean loss is the first summed
    over the second summed; the distributed trainers sum each over ranks."""
    labels_safe = labels.long().clamp_min(0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    valid = (labels >= 0).to(logits.dtype)
    if mask is not None:
        valid = valid * mask
    w = class_weights[labels_safe] * valid
    return w * nll, w


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """logits [..., C], labels [...] int, class_weights [C], mask [...] (1.0
    = real element) -> the weighted-mean loss, a scalar."""
    wnll, w = weighted_nll_terms(logits, labels, class_weights, mask)
    return wnll.sum() / w.sum().clamp_min(1e-12)


def weighted_cross_entropy_per_graph(logits: torch.Tensor, labels: torch.Tensor,
                                     class_weights: torch.Tensor,
                                     mask: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """logits [B, N, C] -> [B]: each graph's loss equals
    weighted_cross_entropy on that graph alone (the batched evaluation's
    per-brain loss, `model/gnn_model.py:51-74`)."""
    wnll, w = weighted_nll_terms(logits, labels, class_weights, mask)
    return wnll.sum(dim=1) / w.sum(dim=1).clamp_min(1e-12)
