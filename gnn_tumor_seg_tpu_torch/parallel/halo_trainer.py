"""The trainer of the node-partitioned (halo) regime (counterpart of
gnn_tumor_seg_tpu/parallel/halo_trainer.py).

One step is forward, global weighted cross-entropy, backward and AdamW over
one giant partitioned union graph; an epoch is a pass over the unions, with
the learning rate set from the epoch counter (train/optim.py) as on one
device. Every rank holds a replica of the parameters and of the optimizer
state; the gradients are summed over ranks (collectives.all_reduce_grads)
before each step, so the replicas stay equal.

The parameters are the single-device model's, and `save_weights` writes the
standard checkpoint (rank 0 only, then a barrier), so a halo-trained model
serves through cli/common.load_gnn_from_checkpoint and resumes on one
device, and the reverse. Dropout draws from a generator seeded by (seed,
epoch), and by the rank in the p2p variant, whose masks are drawn at each
node's home rank (JAX halo.py:432-436); the all_gather variant uses one
mask on every rank (:474-476).
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch

from .. import evaluation
from ..config import HyperParams
from ..data.image import project_nodes_to_img
from ..models.factory import SAGE_AGGREGATORS, init_graph_net
from ..ops.precision import precision_scope
from ..train.gnn_trainer import restore_training_state
from ..train.losses import weighted_cross_entropy
from ..train.optim import epoch_lr, make_optimizer, opt_state_leaves, set_lr
from .collectives import all_gather_rows, all_reduce_grads, launches_by_rank
from .halo import (HaloGAT, HaloGATP2P, HaloGraphSage, HaloGraphSageP2P,
                   PartitionedGraph, place_partition)
from .halo_data import unpermute_nodes
from .mesh import Mesh
from .multihost import save_checkpoint_coordinator

__all__ = ["init_halo_net", "HaloTrainer"]

_VARIANTS = ("all_gather", "p2p")


def init_halo_net(model_type: str, hp: HyperParams, mesh: Mesh,
                  variant: str = "all_gather", halo_width: int | None = None,
                  generator: torch.Generator | None = None):
    """The halo model of `model_type` (models/factory.init_graph_net's
    model, drawn from `generator`, wrapped for the partitioned regime)."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown halo variant {variant!r}")
    if variant == "p2p" and halo_width is None:
        raise ValueError("variant='p2p' requires halo_width")
    base = init_graph_net(model_type, hp, generator)
    if model_type in SAGE_AGGREGATORS:
        if variant == "p2p":
            return HaloGraphSageP2P(base, mesh, halo_width)
        return HaloGraphSage(base, mesh)
    if variant == "p2p":
        return HaloGATP2P(base, mesh, halo_width)
    return HaloGAT(base, mesh)


class HaloTrainer:
    """Optimizer-driven training over one or more PartitionedGraphs, one
    rank of `mesh`."""

    def __init__(self, model_type: str, hp: HyperParams,
                 graphs: Sequence[PartitionedGraph], mesh: Mesh,
                 variant: str = "all_gather", halo_width: int | None = None,
                 seed: int = 0, resume_from: str | None = None,
                 precision: str | None = None):
        self.model_type = model_type
        self.hp = hp
        self.mesh = mesh
        self.variant = variant
        self.halo_width = halo_width
        if precision is None:
            precision = os.environ.get("GTS_PALLAS_PRECISION", "fast")
        if precision not in ("exact", "fast"):
            raise ValueError(f"precision must be exact or fast, got {precision!r}")
        self.precision = precision
        self._seed = seed
        self.model = init_halo_net(model_type, hp, mesh, variant, halo_width,
                                   torch.Generator().manual_seed(seed))
        self.model.to(mesh.device)
        self.optimizer = make_optimizer(self.model.jax_parameters(), hp)
        self.epoch = 0
        self.class_weights = torch.tensor(hp.class_weights, dtype=torch.float32,
                                          device=mesh.device)
        self.graphs = [place_partition(g, mesh, halo_width) for g in graphs]
        self.last_epoch_stats: dict = {}
        if resume_from:
            epoch = restore_training_state(resume_from, self.model.base,
                                           self.optimizer, model_type)
            if epoch is not None:
                self.epoch = epoch

    def _generator(self) -> torch.Generator:
        key = [self._seed + 1, self.epoch]
        if self.model.dropout_per_rank:
            key.append(self.mesh.rank)
        seed = int(np.random.SeedSequence(key).generate_state(1)[0])
        return torch.Generator(device=self.mesh.device).manual_seed(seed)

    # ------------------------------------------------------------------ step
    def loss_and_grads(self, rg, generator=None) -> torch.Tensor:
        """A step short of AdamW: the global loss on the rank's graph `rg`
        (returned, the same on every rank) and, in each parameter's .grad,
        the gradient summed over ranks."""
        loss = self.model.loss(rg, self.class_weights, train=True,
                               generator=generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(self.model.jax_parameters(), self.mesh)
        return loss.detach()

    def _step(self, rg, generator) -> torch.Tensor:
        loss = self.loss_and_grads(rg, generator)
        self.optimizer.step()
        return loss

    def run_epoch(self) -> float:
        """One pass over the unions; returns the mean of their global
        losses (the same on every rank)."""
        generator = self._generator()
        set_lr(self.optimizer, epoch_lr(self.hp.lr, self.hp.lr_decay,
                                        self.epoch))
        t0 = time.perf_counter()
        with launches_by_rank(self.mesh) as counts, \
                precision_scope(self.precision):
            losses = []
            for rg in self.graphs:
                with torch.profiler.record_function("halo_train_step"):
                    losses.append(self._step(rg, generator))
            mean_loss = float(torch.stack(losses).double().mean())
            seconds = time.perf_counter() - t0
        self.last_epoch_stats = {
            "seconds": seconds,
            "steps": len(losses),
            "variant": self.variant,
            "ranks": self.mesh.world_size,
            "precision": self.precision,
            "impl": "cuda" if self.mesh.device.type == "cuda" else "plain",
            "launches_by_rank": counts,
        }
        self.epoch += 1
        return mean_loss

    # ------------------------------------------------------------------ eval
    def _placed(self, b):
        """The rank's placement of a PartitionedBatch, kept on the batch
        (evaluate_loss reads the validation unions every epoch)."""
        key = (self.mesh.rank, self.mesh.world_size, str(self.mesh.device))
        cached = getattr(b, "_placed", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        rg = place_partition(b.pg, self.mesh, b.halo_width)
        b._placed = (key, rg)
        return rg

    @torch.no_grad()
    def evaluate_loss(self, batches) -> float:
        """Mean global validation loss over PartitionedBatches, in "exact"
        (the early-stop signal of a k-fold halo run)."""
        if not batches:
            return float("nan")
        with precision_scope("exact"):
            total = sum(float(self.model.loss(self._placed(b),
                                              self.class_weights))
                        for b in batches)
        return total / len(batches)

    @torch.no_grad()
    def own_logits(self, rg) -> torch.Tensor:
        """float32 logits [shard, C] of the rank's own rows, in "exact"."""
        with precision_scope("exact"):
            return self.model(rg)

    @torch.no_grad()
    def evaluate(self, batches, data=None):
        """Per-brain metrics averaged over the set, the reference's
        10-metric vector and 8 label counts (`model/gnn_model.py:51-74`).
        The forward runs partitioned; every rank gathers the union's logits
        ([N, C], small) and computes the same per-brain metrics on the host
        (voxel metrics from `data`; data=None leaves them 0)."""
        rows_m, rows_c = [], []
        for b in batches:
            rg = self._placed(b)
            full = all_gather_rows(self.own_logits(rg), self.mesh)
            logits = unpermute_nodes(
                full.cpu().numpy().reshape(b.pg.n_parts, b.pg.shard_size, -1),
                b.n_total)
            if b.pg.labels is None:
                raise ValueError("evaluate requires labelled graphs")
            labels = unpermute_nodes(b.pg.labels, b.n_total)
            cw = self.class_weights.cpu()
            for s, mri_id in enumerate(b.sample_ids):
                lo, hi = int(b.offsets[s]), int(b.offsets[s + 1])
                lg, lb = logits[lo:hi], labels[lo:hi]
                m = np.zeros(10)
                m[0] = float(weighted_cross_entropy(torch.from_numpy(lg),
                                                    torch.from_numpy(lb), cw))
                preds = np.argmax(lg, axis=-1)
                m[1:4] = evaluation.calculate_node_dices(preds, lb)
                if data is not None:
                    sv = data.get_supervoxel_partitioning(mri_id)
                    true_vox = data.get_voxel_labels(mri_id)
                    m[4:] = evaluation.calculate_brats_metrics(
                        project_nodes_to_img(sv, preds), true_vox)
                rows_m.append(m)
                rows_c.append(np.concatenate([
                    evaluation.count_node_labels(preds),
                    evaluation.count_node_labels(lb)]))
        return (np.mean(np.stack(rows_m), axis=0),
                np.sum(np.stack(rows_c), axis=0))

    # ----------------------------------------------------------- checkpoints
    def save_weights(self, folder: str, name: str,
                     include_opt_state: bool = True) -> None:
        """The standard checkpoint, written by rank 0; every rank waits."""
        save_checkpoint_coordinator(
            f"{folder}{name}.ckpt", self.model.base, self.model_type, self.hp,
            opt_state=(opt_state_leaves(self.optimizer) if include_opt_state
                       else None),
            extra={"epoch": self.epoch}, mesh=self.mesh)
