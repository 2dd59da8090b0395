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

The graphed step. On CUDA, GNNTrainer's own step (a subclass that overrides
`_step`, as the data-parallel trainer does, keeps its eager step and a
plain AdamW) is captured as one CUDA graph per batch key: the shapes and
dtypes of the batch's tensors, which optional ones it carries, and the
precision mode. The first step of a key runs eager on a side stream (it
builds the kernels and AdamW's state); the next one captures forward,
weighted CE, backward and AdamW (capturable, its learning rate a device
tensor, train/optim.py) on a static batch, and it and every later step of
the key are a copy into that static batch (batch_graphs writes straight
into it) and one replay, which returns a clone of the static loss. A step
that draws from the dropout generator (feature or attention dropout) stays
eager: the warm-up step shows whether it does. At most MAX_STEP_GRAPHS keys
are kept; other keys, and every step on the CPU, run eager. Restoring state
drops the graphs; the next steps warm up and capture again. The kernels'
`.launches` counters count a captured launch once, not once per replay.

`last_epoch_stats` holds the epoch's wall (`seconds`, the span of the unit
"train.epoch", spans.py) and `host_s`, the host's seconds by phase of the
step: `batch` (device-cache lookups, uploads on a miss, padding and
batch_graphs, into a graph's static batch where one is kept), `forward`
(model and loss), `backward`, `optim` (zero_grad and AdamW), `replay` (a
captured step's replay and the clone of its loss) and the epoch's one
`epoch_sync`; with `cache_misses` and `upload_bytes`, the graphs and bytes
copied to the device on misses, and `graph_captures` and `graph_replays`,
the steps captured and replayed. A model with `step_counts` (GPS: its
attention pairs, `attn_pairs` and `attn_real_pairs`, and its GatedGCN edge
blocks, `gated_edge_layers` and `gated_edge_fused`) adds its counters of
every step, replayed or eager, on the host.

Metric vector of `evaluate`, as the reference: loss; WT/CT/ET node Dice;
WT/CT/ET voxel Dice; WT/CT/ET HD95; plus predicted and true node-label counts
(`model/gnn_model.py:51-74`).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time

import numpy as np
import torch

from .. import evaluation, spans
from ..config import HyperParams
from ..convert import load_gnn_params, load_leaves
from ..data.cache import LRUBytesCache, device_cache_bytes, nbytes_of
from ..data.image import project_nodes_to_img
from ..models.factory import init_graph_net
from ..ops.graph import (DEGREE_BUCKETS, NODE_BUCKETS, GraphBatch, batch_graphs,
                         batch_spec, bucket_size, masked_copy)
from ..ops.precision import (get_precision_mode, precision_scope,
                             training_precision)
from ..runtime import resolve_device
from .checkpoint import load_checkpoint, load_opt_state, save_checkpoint
from .losses import weighted_cross_entropy, weighted_cross_entropy_per_graph
from .optim import (epoch_lr, load_opt_state_leaves, make_optimizer,
                    opt_state_leaves, set_lr)

__all__ = ["GNNTrainer", "restore_training_state"]

# the host phases of a training step, and the epoch's synchronize
HOST_PHASES = ("batch", "forward", "backward", "optim", "replay", "epoch_sync")
# the most batch keys a trainer keeps a captured step for
MAX_STEP_GRAPHS = 4


def _dropout_seed(seed: int, epoch: int) -> int:
    return int(np.random.SeedSequence([seed + 1, epoch]).generate_state(1)[0])


def _batch_key(graphs, n_pad: int, d_pad: int) -> tuple:
    """A captured step's key: the shapes and dtypes of the batch of `graphs`
    (batch_spec) and the precision mode."""
    return batch_spec(graphs, n_pad, d_pad), get_precision_mode()


class _CapturedStep:
    """One batch key's step as a CUDA graph: the static batch it reads, the
    static loss it writes, and the graph (None until captured)."""

    def __init__(self, batch: GraphBatch):
        self.batch = GraphBatch(**{
            f.name: (None if getattr(batch, f.name) is None
                     else torch.empty_like(getattr(batch, f.name)))
            for f in dataclasses.fields(GraphBatch)})
        self.loss = None
        self.graph = None

    def stage(self, batch: GraphBatch) -> None:
        if batch is not self.batch:
            for f in dataclasses.fields(GraphBatch):
                t = getattr(batch, f.name)
                if t is not None:
                    getattr(self.batch, f.name).copy_(t)


def restore_training_state(path: str, model, optimizer, model_type: str,
                           shard=None) -> int | None:
    """Load a checkpoint's parameters (and buffers, where it has them) into
    `model` in place (convert.load_leaves) and, when it has them, its
    optimizer state into `optimizer`.
    `shard(i, leaf)`, when given, maps parameter i's whole leaf (and its two
    moments) to the part the model holds (tensor parallelism). Returns the
    checkpoint's epoch counter, or None."""
    leaves, ckpt_type, _, manifest = load_checkpoint(path)
    if ckpt_type != model_type:
        raise ValueError(f"checkpoint holds a {ckpt_type}, the trainer a "
                         f"{model_type}")
    if shard is None:
        shard = lambda i, leaf: leaf  # noqa: E731
    load_leaves(model, leaves, manifest.get("buffers"), shard)
    opt = load_opt_state(path)
    if opt is not None:
        n = len(leaves)
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
        self.precision = training_precision(precision)
        self._seed = seed
        self.model = init_graph_net(model_type, hp,
                                    torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        graphed = (self.device.type == "cuda"
                   and type(self)._step is GNNTrainer._step)
        self.optimizer = make_optimizer(self.model.jax_parameters(), hp,
                                        capturable=graphed)
        # batch key -> _CapturedStep, or None for a key whose step stays
        # eager; None on the eager-only paths
        self._graphs: dict | None = {} if graphed else None
        self.epoch = 0
        self.class_weights = torch.tensor(hp.class_weights, dtype=torch.float32,
                                          device=self.device)
        self.train_data = train_data
        self._device_cache = LRUBytesCache(device_cache_bytes())
        self._edge_counts: dict[int, int] = {}
        self._node_counts: dict[int, int] = {}
        self._shape_budget = None
        self.last_epoch_stats: dict = {}
        self.last_eval_stats: dict = {}
        self._epoch_stats = self._new_epoch_stats()
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
    @staticmethod
    def _new_epoch_stats() -> dict:
        return {"host_s": dict.fromkeys(HOST_PHASES, 0.0), "cache_misses": 0,
                "upload_bytes": 0, "graph_captures": 0, "graph_replays": 0}

    def _get_graph(self, i: int) -> GraphBatch:
        """Sample i on the device; its real edges and nodes are counted on
        the host before the copy."""
        g = self._device_cache.get(i)
        if g is None:
            g = self.train_data.get_graph(i)
            if i not in self._edge_counts:
                self._edge_counts[i] = int(g.nbr_mask.sum())
                self._node_counts[i] = int(g.n_nodes.sum())
            g = g.to(self.device)
            self._device_cache.put(i, g)
            spans.count("cache_misses", 1, self._epoch_stats)
            spans.count("upload_bytes", nbytes_of(g), self._epoch_stats)
        return g

    def _step(self, batch: GraphBatch, generator: torch.Generator) -> torch.Tensor:
        """One step: a replay of its key's captured graph where the trainer
        keeps one (module doc), else eager. Returns the loss."""
        if self._graphs is None:
            return self._eager_step(batch, generator)
        key = _batch_key([batch], batch.num_nodes_padded, batch.max_degree)
        if key not in self._graphs:
            if len(self._graphs) >= MAX_STEP_GRAPHS:
                return self._eager_step(batch, generator)
            return self._warm_up(key, batch, generator)
        step = self._graphs[key]
        if step is None:
            return self._eager_step(batch, generator)
        host_s = self._epoch_stats["host_s"]
        with spans.span("train.batch", host_s, "batch"):
            step.stage(batch)
        if step.graph is None:
            self._capture(step, generator)
        with spans.span("train.replay", host_s, "replay"):
            step.graph.replay()
            loss = step.loss.clone()
        spans.count("graph_replays", 1, self._epoch_stats)
        return loss

    def _eager_step(self, batch: GraphBatch,
                    generator: torch.Generator) -> torch.Tensor:
        host_s = self._epoch_stats["host_s"]
        with spans.span("train.forward", host_s, "forward"):
            logits = self.model(batch, train=True, generator=generator)
            loss = weighted_cross_entropy(logits, batch.labels,
                                          self.class_weights, batch.node_mask)
        with spans.span("train.optim", host_s, "optim"):
            self.optimizer.zero_grad(set_to_none=True)
        with spans.span("train.backward", host_s, "backward"):
            loss.backward()
        with spans.span("train.optim", host_s, "optim"):
            self.optimizer.step()
        return loss.detach()

    def _warm_up(self, key, batch: GraphBatch,
                 generator: torch.Generator) -> torch.Tensor:
        """A key's first step: eager, on a side stream, as capture asks. It
        keeps a static batch for the key, or None where the step drew from
        `generator`."""
        before = generator.get_state()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            loss = self._eager_step(batch, generator)
        current.wait_stream(side)
        draws = not torch.equal(before, generator.get_state())
        self._graphs[key] = None if draws else _CapturedStep(batch)
        return loss

    def _capture(self, step: _CapturedStep, generator: torch.Generator) -> None:
        """Record the step on `step`'s static batch; capture runs nothing,
        so the replay after it takes the step."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step.loss = self._eager_step(step.batch, generator)
        step.graph = graph
        spans.count("graph_captures", 1, self._epoch_stats)

    def _drop_graphs(self) -> None:
        """Forget the captured steps (state they hold was replaced)."""
        if self._graphs:
            self._graphs.clear()

    def _static_batch(self, graphs, n_pad: int, d_pad: int) -> GraphBatch | None:
        """The static batch of a kept graph for the batch of `graphs`, for
        batch_graphs to write into; None where that step runs eager."""
        if not self._graphs:
            return None
        step = self._graphs.get(_batch_key(graphs, n_pad, d_pad))
        return None if step is None else step.batch

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
        step_counts = getattr(self.model, "step_counts", None)
        losses = []
        edges = 0
        stats = self._epoch_stats = self._new_epoch_stats()
        host_s = stats["host_s"]
        with spans.unit("train.epoch", stats, "seconds"):
            with precision_scope(self.precision):
                for idx, size, pad_from in self._epoch_batches(order):
                    with spans.span("train.batch", host_s, "batch"):
                        graphs = []
                        for i in idx:
                            graphs.append(self._get_graph(int(i)))
                            edges += self._edge_counts[int(i)]
                        if len(graphs) < size:    # remainder batch: same shape
                            pad = masked_copy(graphs[0] if graphs
                                              else self._get_graph(int(pad_from)))
                            graphs += [pad] * (size - len(graphs))
                        batch = batch_graphs(
                            graphs, n_pad=n_pad, d_pad=d_pad,
                            out=self._static_batch(graphs, n_pad, d_pad))
                    with spans.span("gnn_train_step"):
                        losses.append(self._step(batch, generator))
                    if step_counts is not None:
                        nodes = [self._node_counts[int(i)] for i in idx]
                        nodes += [0] * (size - len(nodes))
                        for k, v in step_counts(nodes, n_pad).items():
                            spans.count(k, v, stats)
            # the epoch's one host synchronization
            with spans.span("train.epoch_sync", host_s, "epoch_sync"):
                mean_loss = float(torch.stack(losses).double().mean())
        stats.update(
            steps=len(losses),
            edges_per_s=edges * self.model.num_layers / max(stats["seconds"], 1e-9),
            impl="cuda" if self.device.type == "cuda" else "plain",
            precision=self.precision)
        self.last_epoch_stats = stats
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
        or GAT, as the trainer's model; a GPS has no JAX counterpart)."""
        load_gnn_params(self.model, params)
        self._drop_graphs()

    def restore(self, path: str) -> None:
        """Resume the training state (parameters, optimizer, epoch) from a
        checkpoint of either package; a checkpoint without optimizer state
        restores the parameters and leaves the optimizer as it is."""
        epoch = restore_training_state(path, self.model, self.optimizer,
                                       self.model_type)
        self._drop_graphs()
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
