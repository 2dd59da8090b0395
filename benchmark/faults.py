"""Faults planted in the program underneath a run, to show that `correct`
catches each fault a cell can have (tests/test_bench_correct.py on the CPU,
control.py --fault on the card at the cells' own sizes). Each is a context
manager that patches one of the program's functions for its duration.

Serve: `gnn_node` (one node's logits altered where the GNN produces
them), `gnn_half` (the second half of the nodes left out), `label` (one
voxel's served label altered), `stale` (every request answers with the
first one's labels), `connectivity` (the connectivity pass leaves SLIC's
cells as they are). Train: `unchanged` (a step that returns its state
unchanged: no optimizer step), `half` (half of the batch left out, the
mean taken over the rest), `altered` (one leaf's gradient altered where
it is produced), `cache_stale` (the trainer's device cache answers every
hit with the first graph it holds: epoch 0, which fills the cache, is
sound, and only the window's epochs train on wrong graphs).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _gnn_rows(rows):
    from gnn_tumor_seg_tpu_torch.models.sage import GraphSage

    forward = GraphSage.forward

    def broken(self, *a, **k):
        out = forward(self, *a, **k).clone()
        out[:, rows(out.shape[1])] = 0.0
        return out

    return _patched(GraphSage, "forward", broken)


def _labels(change):
    from gnn_tumor_seg_tpu_torch.cli import predict_single as ps

    return _patched(ps, "swap_labels_to_brats", change(ps.swap_labels_to_brats))


def _one_label(swap):
    def broken(labels):
        out = swap(labels)
        idx = tuple(s // 2 for s in out.shape)
        out[idx] = 4 if out[idx] != 4 else 1
        return out

    return broken


def _stale(swap):
    first = []

    def broken(labels):
        out = swap(labels)
        if not first:
            first.append(out)
        return first[0].copy()

    return broken


def _trainer_step(fault):
    from gnn_tumor_seg_tpu_torch.train import gnn_trainer as gt

    def step(self, batch, generator):
        logits = self.model(batch, train=True, generator=generator)
        mask = batch.node_mask
        if fault == "half":
            keep = torch.zeros_like(mask)
            keep[: mask.shape[0] // 2] = 1
            mask = mask * keep
        loss = gt.weighted_cross_entropy(logits, batch.labels, self.class_weights, mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if fault == "altered":
            self.model.jax_parameters()[2].grad.mul_(0.5)
        if fault != "unchanged":
            self.optimizer.step()
        return loss.detach()

    return _patched(gt.GNNTrainer, "_step", step)


def _no_connectivity():
    from gnn_tumor_seg_tpu_torch.data import native

    return _patched(native, "enforce_connectivity_native",
                    lambda labels: labels.astype("int32", copy=True))


def _cache_stale():
    from gnn_tumor_seg_tpu_torch.train import gnn_trainer as gt

    get_graph = gt.GNNTrainer._get_graph

    def broken(self, i):
        hit = self._device_cache.get(i) is not None
        g = get_graph(self, i)
        if hit:
            first = getattr(self, "_fault_first", None)
            if first is None:
                self._fault_first = first = g
            return first
        return g

    return _patched(gt.GNNTrainer, "_get_graph", broken)


FAULTS = {
    "gnn_node": lambda: _gnn_rows(lambda n: slice(3, 4)),
    "gnn_half": lambda: _gnn_rows(lambda n: slice(n // 2, n)),
    "label": lambda: _labels(_one_label),
    "stale": lambda: _labels(_stale),
    "unchanged": lambda: _trainer_step("unchanged"),
    "half": lambda: _trainer_step("half"),
    "altered": lambda: _trainer_step("altered"),
    "connectivity": _no_connectivity,
    "cache_stale": _cache_stale,
}


def planted(name: str):
    """The fault `name` as a context manager."""
    return FAULTS[name]()
