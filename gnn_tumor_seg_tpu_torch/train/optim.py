"""Optimizer: AdamW with a learning rate decayed once per epoch
(counterpart of gnn_tumor_seg_tpu/train/optim.py).

The reference's torch.optim.AdamW (betas 0.9/0.999, eps 1e-8, decoupled
weight decay scaled by lr) and ExponentialLR(gamma) stepped once per epoch
(`model/gnn_model.py:28-29,47`). The JAX package injects
lr * decay**epoch from an explicit epoch counter; here the trainer sets the
same value (computed in float32, as there) on the optimizer at the start of
each epoch, so the number of steps per epoch does not matter and a resumed
run continues the schedule. The optimizer is torch.optim.AdamW itself; its
state stays on the parameters' device.

Checkpoints carry the optimizer state as the JAX package's does: the leaves
of optax's inject_hyperparams(adamw) state in its flatten order,

  0       inject count (int32)
  1..6    b1, b2, eps, eps_root, learning_rate, weight_decay (float32)
  7       Adam count (int32)
  then    mu, one leaf per parameter, in parameter order
  then    nu, likewise,

with the parameters in the JAX pytree order (the model's jax_parameters), so
a checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_optimizer", "epoch_lr", "set_lr", "opt_state_leaves",
           "load_opt_state_leaves", "BETAS", "EPS"]

BETAS = (0.9, 0.999)
EPS = 1e-8
_N_SCALARS = 8      # inject count, six hyperparameters, Adam count


def make_optimizer(params: list[torch.nn.Parameter], hp) -> torch.optim.AdamW:
    """AdamW over `params` (keep their order: it is the checkpoint's)."""
    return torch.optim.AdamW(params, lr=hp.lr, betas=BETAS, eps=EPS,
                             weight_decay=hp.w_decay)


def epoch_lr(base_lr: float, decay: float, epoch: int) -> float:
    """base_lr * decay**epoch in float32, as the JAX train state computes it
    (optim.py:31-33 there)."""
    return float(np.float32(base_lr) * np.float32(decay) ** np.float32(epoch))


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _params(opt: torch.optim.Optimizer) -> list[torch.nn.Parameter]:
    return [p for group in opt.param_groups for p in group["params"]]


def opt_state_leaves(opt: torch.optim.AdamW) -> list[np.ndarray]:
    """The optimizer state as optax's flatten-order leaves (module doc)."""
    params = _params(opt)
    group = opt.param_groups[0]
    states = [opt.state.get(p, {}) for p in params]
    count = int(states[0]["step"]) if "step" in states[0] else 0
    f32 = np.float32
    leaves = [np.asarray(count, np.int32),
              np.asarray(group["betas"][0], f32),
              np.asarray(group["betas"][1], f32),
              np.asarray(group["eps"], f32),
              np.asarray(0.0, f32),
              np.asarray(group["lr"], f32),
              np.asarray(group["weight_decay"], f32),
              np.asarray(count, np.int32)]
    for key in ("exp_avg", "exp_avg_sq"):
        for p, st in zip(params, states):
            leaves.append(st[key].detach().cpu().numpy() if key in st
                          else np.zeros(tuple(p.shape), f32))
    return leaves


def load_opt_state_leaves(opt: torch.optim.AdamW,
                          leaves: list[np.ndarray]) -> None:
    """Set the optimizer's state from optax flatten-order leaves (module
    doc); the learning rate is left alone, since the trainer sets it from
    the epoch."""
    params = _params(opt)
    n = len(params)
    if len(leaves) != _N_SCALARS + 2 * n:
        raise ValueError(f"{len(leaves)} optimizer leaves for {n} parameters; "
                         f"expected {_N_SCALARS + 2 * n}")
    count = int(leaves[7])
    mu, nu = leaves[_N_SCALARS:_N_SCALARS + n], leaves[_N_SCALARS + n:]
    for p, m, v in zip(params, mu, nu):
        if tuple(np.shape(m)) != tuple(p.shape) or \
                tuple(np.shape(v)) != tuple(p.shape):
            raise ValueError(f"optimizer moments {np.shape(m)}, {np.shape(v)} "
                             f"do not match a parameter of {tuple(p.shape)}")
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.asarray(m, np.float32)).to(p.device),
            "exp_avg_sq": torch.as_tensor(np.asarray(v, np.float32)).to(p.device),
        }
