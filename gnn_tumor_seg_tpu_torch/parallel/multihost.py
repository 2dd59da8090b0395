"""Per-rank plumbing of the distributed regimes (counterpart of
gnn_tumor_seg_tpu/parallel/multihost.py): sample shards, rank-0
checkpoints, combined evaluation.

Every rank runs the same steps (a rank that ran one extra step would hang
the collectives), and exactly one rank publishes checkpoints and progress
files. Without a process group every function here is the single-process
identity.

JAX's `make_global_batch` (`:108`) assembles one global device array from
the hosts' local slices, because a jitted SPMD step takes the global batch.
Here no global array exists: each rank's step takes its local batch, the
r-th slice of the global batch (parallel/dp.py), and the collectives
(collectives.py) do what the global array's sharding did.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch.distributed as dist

from .collectives import all_gather_host
from .mesh import Mesh

__all__ = ["process_shard", "barrier", "save_checkpoint_coordinator",
           "combine_eval_results"]


def process_shard(items: Sequence, rank: int, world_size: int) -> list:
    """Contiguous per-rank shard of `items`, wrap-padded to equal length:
    every rank gets ceil(len / P) items, a short last slice wrapping to the
    front of the list, so every rank runs the same number of steps (JAX
    multihost.py:31)."""
    items = list(items)
    if world_size <= 1 or not items:
        return items
    per = -(-len(items) // world_size)
    start = rank * per
    return [items[(start + i) % len(items)] for i in range(per)]


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.world_size > 1:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def save_checkpoint_coordinator(path: str, model, model_type: str, hp,
                                opt_state=None, extra: dict | None = None,
                                mesh: Mesh | None = None) -> bool:
    """Rank 0 writes the checkpoint (train/checkpoint.save_checkpoint), the
    others do not; then every rank waits at a barrier, so none goes on (or
    exits) before the file is in place. Returns True on the writing rank."""
    from ..train.checkpoint import save_checkpoint

    wrote = False
    if mesh is None or mesh.is_coordinator:
        save_checkpoint(path, model, model_type, hp, opt_state=opt_state,
                        extra=extra)
        wrote = True
    barrier(mesh)
    return wrote


def combine_eval_results(metrics: np.ndarray, counts: np.ndarray, n_local: int,
                         mesh: Mesh | None = None
                         ) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-rank evaluation results -> the global ones: the sample-weighted
    mean of the 10-metric vectors and the sum of the label counts, what one
    process evaluating every sample computes (JAX multihost.py:85).
    Without a mesh of more than one rank: the identity."""
    metrics = np.asarray(metrics, np.float64)
    counts = np.asarray(counts, np.float64)
    if mesh is None or mesh.world_size <= 1:
        return metrics, counts, n_local
    packed = np.concatenate([metrics * n_local, counts, [float(n_local)]])
    rows = all_gather_host(packed, mesh)               # [P, 10 + 8 + 1]
    n_total = rows[:, -1].sum()
    g_metrics = rows[:, :metrics.size].sum(axis=0) / max(n_total, 1.0)
    g_counts = rows[:, metrics.size:-1].sum(axis=0)
    return g_metrics, g_counts, int(n_total)
