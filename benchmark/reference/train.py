"""Plain reference of the first training steps: the GNN of reference/gnn.py
on the union of a batch's graphs, the class-weighted cross-entropy (the
weighted mean of torch.nn.CrossEntropyLoss(weight=w) over every node of
the batch), autograd's gradients, and AdamW (betas 0.9 / 0.999, eps 1e-8,
decoupled weight decay scaled by the learning rate, bias-corrected
moments), as the published trainer takes its steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import gnn
from .precision import Precision

BETAS = (0.9, 0.999)
EPS = 1e-8


def union(graphs, device):
    """One graph of a batch's graphs (numpy feats, src, dst, labels each):
    node ids offset, features and labels stacked; with each node's graph
    index (its graph's place in the batch)."""
    feats, src, dst, labels, graph, off = [], [], [], [], [], 0
    for i, (f, s, d, y) in enumerate(graphs):
        feats.append(torch.from_numpy(np.asarray(f, np.float32)))
        src.append(torch.from_numpy(np.asarray(s, np.int64) + off))
        dst.append(torch.from_numpy(np.asarray(d, np.int64) + off))
        labels.append(torch.from_numpy(np.asarray(y, np.int64)))
        graph.append(torch.full((len(f),), i, dtype=torch.int64))
        off += len(f)
    return tuple(torch.cat(t).to(device) for t in (feats, src, dst, labels, graph))


def weighted_ce(logits, labels, class_weights):
    w = class_weights[labels]
    nll = -torch.log_softmax(logits, -1).gather(-1, labels[:, None])[:, 0]
    return (w * nll).sum() / w.sum()


def steps(config: dict, train: dict, weights: dict, batches, lrs,
          prec: Precision, device, moments=None):
    """Take len(batches) steps from `weights` and, when given, AdamW's
    `moments` (first and second moment by name, and the steps already
    taken); without them the optimizer starts afresh. Returns (the loss of
    each step, the gradient of the first step, the parameters after the
    last), the last two as dicts of float64 tensors by name."""
    params = {k: v.detach().to(device, prec.dtype).clone().requires_grad_(True)
              for k, v in weights.items()}
    m0, v0, t0 = moments if moments is not None else ({}, {}, 0)
    m = {k: m0[k].detach().to(device, prec.dtype).clone() if k in m0
         else torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: v0[k].detach().to(device, prec.dtype).clone() if k in v0
          else torch.zeros_like(v) for k, v in params.items()}
    cw = torch.tensor(train["class_weights"], dtype=prec.dtype, device=device)
    losses, first_grad = [], None
    for t, (graphs, lr) in enumerate(zip(batches, lrs), start=t0 + 1):
        feats, src, dst, labels, graph = union(graphs, device)
        logits = gnn.forward(config, params, feats, src, dst, graph, prec)
        loss = weighted_ce(logits.to(prec.dtype), labels, cw)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().double() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = params[k]
                p.mul_(1 - lr * train["w_decay"])
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v2[k].sqrt() / math.sqrt(1 - BETAS[1] ** t)).add_(EPS)
                p.addcdiv_(m[k], denom, value=-lr / (1 - BETAS[0] ** t))
        del logits, loss, grads
    return (losses, first_grad,
            {k: v.detach().double() for k, v in params.items()})


def leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap between the norms of `got` and `want`, over the
    larger of that leaf's reference norm and the median leaf's; leaves not
    in `keep` (when given) are left out."""
    names = [k for k in want if keep is None or k in keep]
    norms = {k: float(want[k].norm()) for k in names}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for k in names:
        g = got.get(k)
        if g is None or tuple(g.shape) != tuple(want[k].shape):
            return math.inf
        gap = abs(float(g.double().norm()) - norms[k]) / max(norms[k], median, 1e-30)
        worst = max(worst, gap)
    return worst


def moved_leaves(first_grad: dict, rule: float = 1e-3) -> set:
    """Leaves whose reference gradient is above `rule` of the median
    leaf's norm: the others move under Adam by round-off alone."""
    norms = {k: float(g.norm()) for k, g in first_grad.items()}
    median = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n >= rule * median}


def first_gradient(m_before: dict, m_after: dict) -> dict:
    """The gradient AdamW got in a step, from its first moment before and
    after it (m' = b1 m + (1 - b1) g); a moment absent before is 0."""
    return {k: (a.double() - BETAS[0] * m_before[k].double() if k in m_before
                else a.double()) / (1 - BETAS[0]) for k, a in m_after.items()}


def compare(prog: dict, config: dict, train: dict, weights: dict, batches,
            lrs, prec: Precision, device, moments=None) -> dict:
    """The numbers compared for a program (or control) record `prog`:
    `losses` (first steps), `grad` (first gradient by name), `params`
    (after the steps), all from `weights` and `moments` (steps()). Returns
    loss_err, grad_err, change_err."""
    r_loss, r_grad, r_params = steps(config, train, weights, batches, lrs,
                                     prec, device, moments)
    if not all(k in prog for k in ("losses", "grad", "params")):
        return {"loss_err": math.inf, "grad_err": math.inf, "change_err": math.inf}
    loss_err = max((abs(a - b) / max(abs(b), 1e-30)
                    for a, b in zip(prog["losses"], r_loss)), default=math.inf)
    if len(prog["losses"]) != len(r_loss):
        loss_err = math.inf
    w0 = {k: v.double().to(device) for k, v in weights.items()}
    d_ref = {k: r_params[k] - w0[k] for k in r_params}
    d_prog = {k: prog["params"][k].double().to(device) - w0[k]
              for k in prog["params"]}
    grads = {k: v.double().to(device) for k, v in prog["grad"].items()}
    keep = moved_leaves(r_grad)
    return {"loss_err": loss_err,
            "grad_err": leaf_gap(grads, r_grad),
            "change_err": leaf_gap(d_prog, d_ref, keep)}
