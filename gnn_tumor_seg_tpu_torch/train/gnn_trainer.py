"""GNN training and evaluation engine (counterpart of
gnn_tumor_seg_tpu/train/gnn_trainer.py), on one device.

The JAX trainer's behaviour, step for step:
  - the shuffle order np.random.default_rng((seed, epoch)).permutation, so
    both packages visit the same batches, and a run resumed at epoch k
    shuffles (and draws its dropout, from a torch.Generator seeded by seed and
    epoch) exactly like an uninterrupted one;
  - minibatches are stacks over a batch axis at the dataset's bucket shape;
    a short last batch is filled with masked copies that add nothing to the
    weighted-mean loss;
  - one step is forward, weighted CE, backward (the aggregation or fused
    attention kernels' backward passes on the card), AdamW; the learning
    rate is set once per epoch from the epoch counter (train/optim.py);
  - training runs under precision mode "fast" unless the trainer is given
    "exact" (or GTS_PALLAS_PRECISION says so, as for the JAX package);
    evaluation and prediction run in "exact";
  - parameters, optimizer state and the graphs (a byte-bounded LRU of their
    copies on the card) stay on the device; a step makes no host round trip,
    and an epoch synchronizes once, when it reads its losses.

Metric vector of `evaluate`, as the reference: loss; WT/CT/ET node Dice;
WT/CT/ET voxel Dice; WT/CT/ET HD95; plus predicted and true node-label counts
(`model/gnn_model.py:51-74`).
"""

from __future__ import annotations

import concurrent.futures
import os
import time

import numpy as np
import torch

from .. import evaluation
from ..config import HyperParams
from ..convert import load_gnn_params
from ..data.cache import LRUBytesCache, device_cache_bytes
from ..data.image import project_nodes_to_img
from ..models.factory import init_graph_net
from ..ops.graph import (DEGREE_BUCKETS, NODE_BUCKETS, GraphBatch, batch_graphs,
                         bucket_size, masked_copy)
from ..ops.precision import precision_scope
from ..runtime import resolve_device
from .checkpoint import load_checkpoint, load_opt_state, save_checkpoint
from .losses import weighted_cross_entropy, weighted_cross_entropy_per_graph
from .optim import (epoch_lr, load_opt_state_leaves, make_optimizer,
                    opt_state_leaves, set_lr)

__all__ = ["GNNTrainer", "restore_training_state"]

_PRECISIONS = ("exact", "fast")


def _dropout_seed(seed: int, epoch: int) -> int:
    return int(np.random.SeedSequence([seed + 1, epoch]).generate_state(1)[0])


def restore_training_state(path: str, model, optimizer, model_type: str,
                           shard=None) -> int | None:
    """Load a checkpoint's parameters into `model` (in place, JAX flatten
    order) and, when it has them, its optimizer state into `optimizer`.
    `shard(i, leaf)`, when given, maps parameter i's whole leaf (and its two
    moments) to the part the model holds (tensor parallelism). Returns the
    checkpoint's epoch counter, or None."""
    leaves, ckpt_type, _, manifest = load_checkpoint(path)
    if ckpt_type != model_type:
        raise ValueError(f"checkpoint holds a {ckpt_type}, the trainer a "
                         f"{model_type}")
    params = model.jax_parameters()
    if len(leaves) != len(params):
        raise ValueError(f"checkpoint has {len(leaves)} parameter leaves, "
                         f"the model {len(params)}")
    n = len(params)
    if shard is None:
        shard = lambda i, leaf: leaf  # noqa: E731
    leaves = [shard(i, leaf) for i, leaf in enumerate(leaves)]
    with torch.no_grad():
        for p, leaf in zip(params, leaves):
            if tuple(np.shape(leaf)) != tuple(p.shape):
                raise ValueError(f"checkpoint leaf {np.shape(leaf)} does "
                                 f"not match a parameter of {tuple(p.shape)}")
            p.copy_(torch.tensor(np.asarray(leaf, np.float32)))
    opt = load_opt_state(path)
    if opt is not None:
        head, moments = opt[:len(opt) - 2 * n], opt[len(opt) - 2 * n:]
        load_opt_state_leaves(optimizer, head + [
            shard(i % n, m) for i, m in enumerate(moments)])
    epoch = manifest.get("extra", {}).get("epoch")
    return None if epoch is None else int(epoch)


class GNNTrainer:
    def __init__(self, model_type: str, hp: HyperParams, train_data=None,
                 seed: int = 0, precision: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model_type = model_type
        self.hp = hp
        if precision is None:
            precision = os.environ.get("GTS_PALLAS_PRECISION", "fast")
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}, got "
                             f"{precision!r}")
        self.precision = precision
        self._seed = seed
        self.model = init_graph_net(model_type, hp,
                                    torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.optimizer = make_optimizer(self.model.jax_parameters(), hp)
        self.epoch = 0
        self.class_weights = torch.tensor(hp.class_weights, dtype=torch.float32,
                                          device=self.device)
        self.train_data = train_data
        self._device_cache = LRUBytesCache(device_cache_bytes())
        self._edge_counts: dict[int, int] = {}
        self._shape_budget = None
        self.last_epoch_stats: dict = {}
        self.last_eval_stats: dict = {}
        if train_data is not None:
            self._shape_budget = self._compute_shape_budget(train_data)

    # ---------------------------------------------------------------- shapes
    def _compute_shape_budget(self, data) -> tuple[int, int]:
        if hasattr(data, "shape_budget"):
            n, d = data.shape_budget()
            return bucket_size(n, NODE_BUCKETS), bucket_size(d, DEGREE_BUCKETS)
        n_max = d_max = 1
        for i in range(len(data)):
            g = data.get_graph(i)
            n_max = max(n_max, g.num_nodes_padded)
            d_max = max(d_max, g.max_degree)
        return n_max, d_max

    # ---------------------------------------------------------------- step
    def _get_graph(self, i: int) -> GraphBatch:
        """Sample i on the device; its real edges are counted on the host
        before the copy."""
        g = self._device_cache.get(i)
        if g is None:
            g = self.train_data.get_graph(i)
            if i not in self._edge_counts:
                self._edge_counts[i] = int(g.nbr_mask.sum())
            g = g.to(self.device)
            self._device_cache.put(i, g)
        return g

    def _step(self, batch: GraphBatch, generator: torch.Generator) -> torch.Tensor:
        logits = self.model(batch, train=True, generator=generator)
        loss = weighted_cross_entropy(logits, batch.labels, self.class_weights,
                                      batch.node_mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _dropout_seed(self) -> int:
        return _dropout_seed(self._seed, self.epoch)

    def _epoch_batches(self, order):
        """(sample indices, batch size, a sample to copy for padding) of
        each step of the epoch: consecutive chunks of the shuffled order."""
        bs = self.hp.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            yield idx, bs, idx[0]

    # ---------------------------------------------------------------- epochs
    def run_epoch(self) -> float:
        """One shuffled pass over the training data; returns the mean batch
        loss."""
        if self.train_data is None:
            raise RuntimeError("trainer constructed without training data")
        order = np.random.default_rng((self._seed, self.epoch)).permutation(
            len(self.train_data))
        generator = torch.Generator(device=self.device).manual_seed(
            self._dropout_seed())
        set_lr(self.optimizer, epoch_lr(self.hp.lr, self.hp.lr_decay,
                                        self.epoch))
        n_pad, d_pad = self._shape_budget
        losses = []
        edges = 0
        t0 = time.perf_counter()
        with precision_scope(self.precision):
            for idx, size, pad_from in self._epoch_batches(order):
                graphs = []
                for i in idx:
                    graphs.append(self._get_graph(int(i)))
                    edges += self._edge_counts[int(i)]
                if len(graphs) < size:    # remainder batch: same shape
                    pad = masked_copy(graphs[0] if graphs
                                      else self._get_graph(int(pad_from)))
                    graphs += [pad] * (size - len(graphs))
                batch = batch_graphs(graphs, n_pad=n_pad, d_pad=d_pad)
                with torch.profiler.record_function("gnn_train_step"):
                    losses.append(self._step(batch, generator))
        # the epoch's one host synchronization
        mean_loss = float(torch.stack(losses).double().mean())
        dt = time.perf_counter() - t0
        self.last_epoch_stats = {
            "seconds": dt,
            "steps": len(losses),
            "edges_per_s": edges * self.model.num_layers / max(dt, 1e-9),
            "impl": "cuda" if self.device.type == "cuda" else "plain",
            "precision": self.precision,
        }
        self.epoch += 1
        return mean_loss

    # ---------------------------------------------------------------- eval
    @torch.inference_mode()
    def predict_nodes(self, graph: GraphBatch) -> np.ndarray:
        """Node logits for one B=1 graph -> numpy [n_nodes, C] (unpadded)."""
        with precision_scope("exact"):
            logits = self.model(graph.to(self.device))[0]
        return logits[: int(graph.n_nodes[0])].cpu().numpy()

    def evaluate(self, data, indices=None, batch_size: int | None = None,
                 workers: int | None = None):
        """Per-brain metrics averaged over the set.

        Returns (avg_metrics[10], total_counts[8]) as `model/gnn_model.py:51-74`:
        [loss, node WT/CT/ET dice, voxel WT/CT/ET dice, WT/CT/ET hd95],
        [pred counts x4, true counts x4]. Brains go forward in batches of
        `batch_size` (default hp.batch_size) in exact precision, with the
        per-graph losses and the argmax on the device and one copy to the host
        per batch, while the host work per brain (supervoxel and label
        volumes, node->voxel projection, Dice, HD95) runs in a thread pool.
        `last_eval_stats` records the batch count and timing."""
        if indices is None:
            indices = range(len(data))
        indices = [int(i) for i in indices]
        t0 = time.perf_counter()
        bs = batch_size or self.hp.batch_size
        workers = workers or min(8, (os.cpu_count() or 2) + 2)
        metrics = np.zeros((len(indices), 10))
        counts = np.zeros((len(indices), 8))

        def host_metrics(row, i, node_preds, node_labels):
            counts[row] = np.concatenate([
                evaluation.count_node_labels(node_preds),
                evaluation.count_node_labels(node_labels),
            ])
            node_dices = evaluation.calculate_node_dices(node_preds,
                                                         node_labels)
            mri_id = data.ids[i]
            sv = data.get_supervoxel_partitioning(mri_id)
            true_vox = data.get_voxel_labels(mri_id)
            pred_vox = project_nodes_to_img(sv, node_preds)
            voxel_metrics = evaluation.calculate_brats_metrics(pred_vox,
                                                               true_vox)
            metrics[row][1:] = np.concatenate([node_dices, voxel_metrics])

        # the dataset-wide bucket, so every batch has one shape
        n_pad = d_pad = None
        if hasattr(data, "shape_budget"):
            n_raw, d_raw = data.shape_budget()
            n_pad = bucket_size(n_raw, NODE_BUCKETS)
            d_pad = bucket_size(d_raw, DEGREE_BUCKETS)
        n_batches = 0
        with concurrent.futures.ThreadPoolExecutor(workers) as pool, \
                precision_scope("exact"), torch.inference_mode():
            futures = []
            for start in range(0, len(indices), bs):
                chunk = indices[start:start + bs]
                graphs = [data.get_graph(i) for i in chunk]
                if any(g.labels is None for g in graphs):
                    raise ValueError("evaluate requires labelled graphs")
                while len(graphs) < bs:   # same shape for the tail
                    graphs.append(graphs[0])
                host = batch_graphs(graphs, n_pad=n_pad, d_pad=d_pad)
                batch = host.to(self.device)
                logits = self.model(batch)
                losses = weighted_cross_entropy_per_graph(
                    logits, batch.labels, self.class_weights, batch.node_mask)
                preds = logits.argmax(dim=-1).to(torch.int16)
                n_batches += 1
                losses = losses.cpu().numpy()
                preds = preds.cpu().numpy()        # [bs, N] int16, one pull
                labels = host.labels.numpy()
                n_nodes = host.n_nodes.numpy()
                for j, i in enumerate(chunk):
                    row = start + j
                    n = int(n_nodes[j])
                    metrics[row][0] = float(losses[j])
                    futures.append(pool.submit(
                        host_metrics, row, i, preds[j][:n], labels[j][:n]))
            for f in futures:
                f.result()
        self.last_eval_stats = {
            "brains": len(indices),
            "batches": n_batches,
            "batch_size": bs,
            "workers": workers,
            "seconds": time.perf_counter() - t0,
        }
        return np.mean(metrics, axis=0), np.sum(counts, axis=0)

    # ---------------------------------------------------------------- io
    def save_weights(self, folder: str, name: str,
                     include_opt_state: bool = True) -> None:
        """Checkpoint `<folder><name>.ckpt` with the embedded config and (by
        default) the optimizer state and epoch counter, for an exact resume."""
        save_checkpoint(
            f"{folder}{name}.ckpt", self.model, self.model_type, self.hp,
            opt_state=(opt_state_leaves(self.optimizer) if include_opt_state
                       else None),
            extra={"epoch": self.epoch})

    def load_params(self, params: list[dict]) -> None:
        """Set the parameters from the JAX model's parameter list (GraphSage
        or GAT, as the trainer's model)."""
        load_gnn_params(self.model, params)

    def restore(self, path: str) -> None:
        """Resume the training state (parameters, optimizer, epoch) from a
        checkpoint of either package; a checkpoint without optimizer state
        restores the parameters and leaves the optimizer as it is."""
        epoch = restore_training_state(path, self.model, self.optimizer,
                                       self.model_type)
        if epoch is not None:
            self.epoch = epoch

    @classmethod
    def from_checkpoint(cls, path: str, train_data=None, seed: int = 0,
                        precision: str | None = None,
                        device: str | torch.device = "cuda") -> "GNNTrainer":
        """A trainer rebuilt from a checkpoint's embedded config and state."""
        _, model_type, hp, _ = load_checkpoint(path)
        trainer = cls(model_type, hp, train_data, seed=seed,
                      precision=precision, device=device)
        trainer.restore(path)
        return trainer
