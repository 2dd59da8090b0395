"""Data-parallel minibatch training (counterpart of
gnn_tumor_seg_tpu/parallel/dp.py), n_model = 1.

The JAX trainer shards the graph batch over the mesh "data" axis and XLA
inserts the gradient psum. Here each rank is a process with a replica of
the parameters and of the AdamW state, and a step is:

  1. the rank's slice of the global batch: every global batch is the next
     chunk of the one (seed, epoch) permutation that the single-device
     trainer draws (train/gnn_trainer.py), and rank r takes its r-th
     batch_size / P graphs; a short last batch is filled with masked graphs,
     as on one device;
  2. the global weighted cross-entropy, sum(w * nll) / sum(w) over every
     rank's nodes (train/losses.py; JAX computes it over the global batch,
     dp.py:152-161): numerator and denominator are summed over ranks, and
     each rank backpropagates its own numerator over the global
     denominator. DDP's mean of per-rank means would be another loss
     whenever the ranks' weight sums differ;
  3. the gradients summed over ranks (an all-reduce sum, not a mean), then
     the same AdamW step on every rank.

With this rule P ranks train as one device does, up to the order of float
sums. Dropout draws from a generator keyed on (seed, epoch, rank), where
JAX draws one mask over the global batch (ROADMAP.md, deviations). Every
rank agrees on the shape budget at construction (JAX
`_sync_global_budgets`, :78-97), so no rank waits in a collective for a
step another never runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.gnn_trainer import GNNTrainer
from ..train.losses import weighted_nll_terms
from ..train.optim import opt_state_leaves
from .collectives import (all_reduce_grads, all_reduce_max_int, all_reduce_sum,
                          launches_by_rank)
from .mesh import Mesh
from .multihost import save_checkpoint_coordinator

__all__ = ["ParallelGNNTrainer"]


class ParallelGNNTrainer(GNNTrainer):
    """GNNTrainer whose step runs data-parallel over `mesh`.

    train_data is the whole training set on every rank (each rank reads the
    samples of its slices only); hp.batch_size is the global batch and must
    divide evenly over the ranks."""

    def __init__(self, model_type: str, hp, train_data=None, seed: int = 0,
                 mesh: Mesh | None = None, precision: str | None = None):
        if mesh is None:
            raise ValueError("ParallelGNNTrainer needs the rank's mesh "
                             "(parallel/mesh.initialize_multihost)")
        if hp.batch_size % mesh.world_size:
            raise ValueError(f"global batch_size {hp.batch_size} must divide "
                             f"evenly over {mesh.world_size} ranks")
        self.mesh = mesh
        super().__init__(model_type, hp, train_data, seed=seed,
                         precision=precision, device=mesh.device)
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
            [self._seed + 1, self.epoch, self.mesh.rank]).generate_state(1)[0])

    def _epoch_batches(self, order):
        bs = self.hp.batch_size
        local = bs // self.mesh.world_size
        r = self.mesh.rank
        for start in range(0, len(order), bs):
            chunk = order[start:start + bs]
            yield chunk[r * local:(r + 1) * local], local, chunk[0]

    def loss_and_grads(self, batch,
                       generator: torch.Generator | None = None) -> torch.Tensor:
        """Steps 2 and 3 short of AdamW: the global loss of the rank's slice
        `batch` (returned, the same on every rank) and, in each parameter's
        .grad, the gradient summed over ranks."""
        logits = self.model(batch, train=True, generator=generator)
        wnll, w = weighted_nll_terms(logits, batch.labels, self.class_weights,
                                     batch.node_mask)
        num_den = all_reduce_sum(torch.stack([wnll.sum(), w.sum()]), self.mesh)
        loss = num_den[0] / num_den[1].clamp_min(1e-12)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(self.model.jax_parameters(), self.mesh)
        return loss.detach()

    def _step(self, batch, generator: torch.Generator) -> torch.Tensor:
        loss = self.loss_and_grads(batch, generator)
        self.optimizer.step()
        return loss

    def save_weights(self, folder: str, name: str,
                     include_opt_state: bool = True) -> None:
        """Rank 0 writes the standard checkpoint; every rank waits for it."""
        save_checkpoint_coordinator(
            f"{folder}{name}.ckpt", self.model, self.model_type, self.hp,
            opt_state=(opt_state_leaves(self.optimizer) if include_opt_state
                       else None),
            extra={"epoch": self.epoch}, mesh=self.mesh)
