"""Data-parallel minibatch training, with tensor parallelism over a model
axis (counterpart of gnn_tumor_seg_tpu/parallel/dp.py).

The JAX trainer shards the graph batch over the mesh "data" axis, shards
the layer weights' output features over the "model" axis (`tp_leaf_spec`,
`state_shardings`) and lets XLA insert the collectives. Here each rank is a
process on the (n_data, n_model) grid of parallel/mesh.py, with its part of
the parameters and of the AdamW state, and a step is:

  1. the slice of the global batch of the rank's data index: every global
     batch is the next chunk of the one (seed, epoch) permutation that the
     single-device trainer draws (train/gnn_trainer.py), and data index d
     takes its d-th batch_size / n_data graphs (every model rank of d the
     same ones); a short last batch is filled with masked graphs, as on one
     device;
  2. the global weighted cross-entropy, sum(w * nll) / sum(w) over every
     data index's nodes (train/losses.py; JAX computes it over the global
     batch, dp.py:152-161): numerator and denominator are summed over the
     data group, and each rank backpropagates its own numerator over the
     global denominator. DDP's mean of per-rank means would be another loss
     whenever the ranks' weight sums differ;
  3. the gradients summed over the data group (an all-reduce sum, not a
     mean), for sharded and replicated leaves alike, then AdamW on the
     rank's own leaves.

With n_model = M > 1 the model runs tensor-parallel over the model group
(models/sage.py, models/gat.py). `tp_leaf_spec` is JAX's rule: a 2D [in,
out] leaf is sharded on out, a 1D [out] leaf likewise, when the size
divides by M; anything else is replicated. A GAT layer departs from it (a
deviation in storage only, ROADMAP.md): a layer whose heads divide by M
holds H / M whole heads (w, w_res and bias on their head-major [H*F] axis,
attn_l and attn_r on their head axis), and any other GAT layer is
replicated. The full parameters are drawn exactly as on one device and then
sliced (`shard_model`), so TP trains as one device does. A replicated leaf
is computed the same on every model rank, so no reduction runs over the
model group for it. A checkpoint gathers every leaf and both AdamW moments
whole over the model group, and rank 0 writes the standard file, which
loads on one device (and in JAX); `restore` shards it on load, on any mesh.

With this rule the mesh trains as one device does, up to the order of float
sums. Dropout draws from a generator keyed on (seed, epoch, data index), so
the model ranks of a data index draw one mask for their replicated
activations, where JAX draws one mask over the global batch (ROADMAP.md,
deviations). Every rank agrees on the shape budget at construction (JAX
`_sync_global_budgets`, :78-97), so no rank waits in a collective for a
step another never runs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.gat import GatConv
from ..train.checkpoint import gnn_from_leaves
from ..train.gnn_trainer import GNNTrainer, restore_training_state
from ..train.losses import weighted_nll_terms
from ..train.optim import make_optimizer, opt_state_leaves
from .collectives import (all_reduce_grads, all_reduce_max_int, all_reduce_sum,
                          gather_leaf, launches_by_rank)
from .mesh import Mesh
from .multihost import save_checkpoint_coordinator

__all__ = ["tp_leaf_spec", "leaf_axes", "shard_model", "ParallelGNNTrainer"]


def tp_leaf_spec(shape, n_model: int) -> int | None:
    """JAX `tp_leaf_spec` (dp.py:27-35) as the sharded axis: 1 for a 2D
    [in, out] leaf whose out divides by n_model, 0 for a 1D leaf whose size
    does, None (replicated) for anything else."""
    shape = tuple(shape)
    if n_model > 1 and len(shape) == 2 and shape[1] % n_model == 0:
        return 1
    if n_model > 1 and len(shape) == 1 and shape[0] % n_model == 0:
        return 0
    return None


def leaf_axes(model, n_model: int) -> list[int | None]:
    """The sharded axis (or None) of each parameter of the whole `model`, in
    jax_parameters order: tp_leaf_spec for a SAGE layer's leaves; for a GAT
    layer whose heads divide by n_model the head-major axis of w, w_res and
    bias and the head axis of attn_l and attn_r, None for the others."""
    axes = []
    for layer in model.layers:
        if isinstance(layer, GatConv):
            split = n_model > 1 and layer.num_heads % n_model == 0
            axes += [(0 if k in ("attn_l", "attn_r", "bias") else 1) if split
                     else None for k in layer.keys]
        else:
            axes += [tp_leaf_spec(getattr(layer, k).shape, n_model)
                     for k in layer.keys]
    return axes


def _block(x, axis: int, mesh: Mesh):
    """The model rank's block of a whole leaf (numpy array or tensor)."""
    n = x.shape[axis] // mesh.n_model
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(mesh.model_rank * n, (mesh.model_rank + 1) * n)
    return x[tuple(idx)]


def shard_model(model, mesh: Mesh) -> list[int | None]:
    """Replace each sharded parameter of the whole `model` by an
    nn.Parameter holding the rank's block, and set each layer's mesh and
    tensor-parallel flags. Returns leaf_axes(model, mesh.n_model)."""
    axes = leaf_axes(model, mesh.n_model)
    it = iter(axes)
    for layer in model.layers:
        split = {}
        for k in layer.keys:
            split[k] = ax = next(it)
            if ax is not None:
                block = _block(getattr(layer, k).detach(), ax, mesh)
                setattr(layer, k, nn.Parameter(block.contiguous().clone()))
        layer.mesh = mesh
        if isinstance(layer, GatConv):
            layer.tp_heads = split["w"] is not None
        else:
            layer.tp_out = split["bias"] is not None
            layer.tp_pool = split.get("b_pool") is not None
    return axes


class ParallelGNNTrainer(GNNTrainer):
    """GNNTrainer whose step runs data-parallel (and with mesh.n_model > 1
    tensor-parallel) over `mesh`.

    train_data is the whole training set on every rank (each rank reads the
    samples of its slices only); hp.batch_size is the global batch and must
    divide evenly over the data axis."""

    def __init__(self, model_type: str, hp, train_data=None, seed: int = 0,
                 mesh: Mesh | None = None, precision: str | None = None):
        if mesh is None:
            raise ValueError("ParallelGNNTrainer needs the rank's mesh "
                             "(parallel/mesh.initialize_multihost)")
        if model_type == "GPS":
            raise NotImplementedError(
                "GPS normalizes by its batch's statistics; data parallelism "
                "would need them synchronized over the ranks, which the port "
                "does not do: train GPS on one device")
        if hp.batch_size % mesh.n_data:
            raise ValueError(f"global batch_size {hp.batch_size} must divide "
                             f"evenly over {mesh.n_data} data ranks")
        self.mesh = mesh
        super().__init__(model_type, hp, train_data, seed=seed,
                         precision=precision, device=mesh.device)
        self._tp_axes = None
        if mesh.n_model > 1:
            self._tp_axes = shard_model(self.model, mesh)
            self.optimizer = make_optimizer(self.model.jax_parameters(), hp)
        if self._shape_budget is not None:
            self._shape_budget = tuple(
                all_reduce_max_int(self._shape_budget, mesh))

    def run_epoch(self) -> float:
        """GNNTrainer.run_epoch; last_epoch_stats adds each rank's kernel
        launches of the epoch ("launches_by_rank")."""
        with launches_by_rank(self.mesh) as counts:
            loss = super().run_epoch()
        self.last_epoch_stats.update(ranks=self.mesh.world_size,
                                     launches_by_rank=counts)
        return loss

    def _dropout_seed(self) -> int:
        return int(np.random.SeedSequence(
            [self._seed + 1, self.epoch, self.mesh.data_rank]).generate_state(1)[0])

    def _epoch_batches(self, order):
        bs = self.hp.batch_size
        local = bs // self.mesh.n_data
        d = self.mesh.data_rank
        for start in range(0, len(order), bs):
            chunk = order[start:start + bs]
            yield chunk[d * local:(d + 1) * local], local, chunk[0]

    def loss_and_grads(self, batch,
                       generator: torch.Generator | None = None) -> torch.Tensor:
        """Steps 2 and 3 short of AdamW: the global loss of the rank's slice
        `batch` (returned, the same on every rank) and, in each parameter's
        .grad, the gradient summed over the data group."""
        data = self.mesh.along("data")
        logits = self.model(batch, train=True, generator=generator)
        wnll, w = weighted_nll_terms(logits, batch.labels, self.class_weights,
                                     batch.node_mask)
        num_den = all_reduce_sum(torch.stack([wnll.sum(), w.sum()]), data)
        loss = num_den[0] / num_den[1].clamp_min(1e-12)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(self.model.jax_parameters(), data)
        return loss.detach()

    def _step(self, batch, generator: torch.Generator) -> torch.Tensor:
        loss = self.loss_and_grads(batch, generator)
        self.optimizer.step()
        return loss

    # ---------------------------------------------------------------- io
    def _shard_leaf(self, i: int, leaf):
        """Parameter i's whole leaf -> the rank's part of it."""
        ax = None if self._tp_axes is None else self._tp_axes[i]
        return leaf if ax is None else _block(np.asarray(leaf), ax, self.mesh)

    def _whole(self, leaves) -> list[np.ndarray]:
        """The rank's parts of every parameter (or moment) -> whole leaves,
        gathered over the model group (a collective)."""
        out = []
        for leaf, ax in zip(leaves, self._tp_axes):
            t = torch.as_tensor(leaf).to(self.device)
            out.append((t if ax is None else gather_leaf(t, ax, self.mesh))
                       .cpu().numpy())
        return out

    def save_weights(self, folder: str, name: str,
                     include_opt_state: bool = True) -> None:
        """Rank 0 writes the standard checkpoint of the whole model; every
        rank waits for it. Under tensor parallelism every leaf and both
        AdamW moments are first gathered whole over the model group."""
        model = self.model
        opt = opt_state_leaves(self.optimizer) if include_opt_state else None
        if self._tp_axes is not None:
            params = [p.detach() for p in self.model.jax_parameters()]
            model = gnn_from_leaves(self._whole(params), self.model_type, self.hp)
            if opt is not None:
                n = len(params)
                head, mu, nu = opt[:-2 * n], opt[-2 * n:-n], opt[-n:]
                opt = head + self._whole(mu) + self._whole(nu)
        save_checkpoint_coordinator(
            f"{folder}{name}.ckpt", model, self.model_type, self.hp,
            opt_state=opt, extra={"epoch": self.epoch}, mesh=self.mesh)

    def load_params(self, params: list[dict]) -> None:
        """Set the parameters from the JAX model's whole parameter list; under
        tensor parallelism each rank keeps its blocks."""
        i = 0
        parts = []
        for layer, lp in zip(self.model.layers, params):
            part = {}
            for k in layer.keys:
                part[k] = self._shard_leaf(i, lp[k])
                i += 1
            parts.append(part)
        super().load_params(parts)

    def restore(self, path: str) -> None:
        """Resume from a checkpoint of the whole model (either package, any
        mesh): each rank loads its blocks of the parameters and moments."""
        epoch = restore_training_state(path, self.model, self.optimizer,
                                       self.model_type, shard=self._shard_leaf)
        if epoch is not None:
            self.epoch = epoch
