"""The rank's mesh: one process per rank over a torch.distributed process
group (counterpart of gnn_tumor_seg_tpu/parallel/mesh.py).

The JAX package builds a 2-axis device mesh ("data", "model") inside one
program and lets XLA insert the collectives. Here each rank is a process
that owns one device; `Mesh` holds the world size, the rank, the rank's
device, the backend and the process group, with the data and model axis
sizes. The ranks lie on the (n_data, n_model) grid of JAX `make_mesh`
(`:23-31`, a reshape of the device list): global rank r has data index
r // n_model and model index r % n_model. With n_model > 1 (tensor
parallelism, parallel/dp.py) each rank also holds two sub-groups made with
`dist.new_group`: its data group (the ranks of its model index, over which
gradients and the loss are summed) and its model group (the ranks of its
data index, over which a layer's columns are split); `Mesh.along(axis)`
is the rank's view of one axis as a mesh of its own. Every rank creates
every group, in the same order, as new_group requires.

`initialize_multihost` (JAX `:34`, jax.distributed.initialize) becomes
`init_process_group` with a TCP init method and a timeout. Rank r uses
cuda:(r % torch.cuda.device_count()). The backend is chosen once, from the
device and the world size, and never changed after a failure:

  nccl  every rank has a card of its own (world size <= visible cards);
  gloo  the CPU, and ranks that share a card, which NCCL refuses (both
        ranks fail the first collective with "invalid usage" on the card;
        scripts/torch_port_dist_probe.py).

JAX's shardings (`data_sharding`, `replicated`, `shard_graph_batch`,
`:57-80`) have no counterpart: a rank holds its own slice of the data, and
its own copy of the parameters, or with n_model > 1 its shard of each
sharded leaf (parallel/dp.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import socket

import torch
import torch.distributed as dist

from ..runtime import resolve_device

__all__ = ["Mesh", "DIST_TIMEOUT_S", "choose_backend", "rank_device",
           "initialize_multihost", "free_port", "shutdown"]

# how long a rank waits in a collective for the others before it raises
DIST_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: n_data * n_model == world_size."""

    world_size: int
    rank: int
    device: torch.device
    backend: str
    n_data: int
    n_model: int = 1
    group: object | None = None       # None: the default (world) group
    data_group: object | None = None  # n_model > 1: the ranks of my model index
    model_group: object | None = None  # n_model > 1: the ranks of my data index

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    def along(self, axis: str) -> "Mesh":
        """The rank's view of one mesh axis ("data" or "model") as a mesh of
        its own: that axis's size, the rank's index on it and its group. With
        n_model = 1 the data axis is the whole mesh."""
        if axis == "data":
            if self.n_model == 1:
                return self
            return dataclasses.replace(
                self, world_size=self.n_data, rank=self.data_rank, n_model=1,
                group=self.data_group, data_group=None, model_group=None)
        if axis == "model":
            if self.n_model == 1:
                raise ValueError("a mesh with n_model = 1 has no model axis")
            return dataclasses.replace(
                self, world_size=self.n_model, rank=self.model_rank,
                n_data=1, n_model=1, group=self.model_group, data_group=None,
                model_group=None)
        raise ValueError(f"mesh axis {axis!r}: expected 'data' or 'model'")

    @property
    def staged(self) -> bool:
        """True where the ring exchange goes through host buffers: gloo with
        tensors on a card, whose send and recv take CPU tensors only
        (collectives.py)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def rank_device(rank: int, device: str | torch.device = "cuda") -> torch.device:
    """cuda:(rank % visible cards), or the CPU when asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device, world_size: int) -> str:
    """nccl when every rank has a card of its own, else gloo."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A TCP port on localhost that is free now (for tcp://localhost:<port>)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_multihost(init_method: str, world_size: int, rank: int,
                         device: str | torch.device = "cuda",
                         n_model: int = 1, timeout_s: float = DIST_TIMEOUT_S) -> Mesh:
    """Join the process group as `rank` of `world_size` and return the mesh.

    init_method: "tcp://host:port" (the JAX CLI's --coordinator host:port)
    or "file://..."; the rank's device is rank_device(rank, device) and the
    backend choose_backend's. n_model > 1 lays the ranks on the
    (world_size // n_model, n_model) grid and makes the data and model
    groups (module doc)."""
    if world_size < 1 or not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if n_model < 1 or world_size % n_model:
        raise ValueError(f"a model axis of {n_model} does not divide a world "
                         f"of {world_size}")
    dev = rank_device(rank, device)
    backend = choose_backend(dev, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    n_data = world_size // n_model
    groups = {}
    if n_model > 1:
        timeout = datetime.timedelta(seconds=timeout_s)
        # every rank makes every group, in one order: data groups, then model
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                groups["data_group"] = g
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                groups["model_group"] = g
    mesh = Mesh(world_size=world_size, rank=rank, device=dev, backend=backend,
                n_data=n_data, n_model=n_model, **groups)
    if mesh.staged:
        print(f"rank {rank}: gloo on {dev}: the ring exchange stages through "
              "pinned host buffers")
    return mesh


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
